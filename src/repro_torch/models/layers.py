"""Layer primitives of the model zoo (counterpart of
``repro.models.layers``): RMSNorm, RoPE, GQA attention through the flash
kernels (causal or not, with gemma's sliding window, logit softcap and
fixed query scale), DeepSeek's multi-head latent attention (MLA), the
decode step's plain attention over a cache buffer, the SwiGLU FFN, the
top-k MoE FFN, the Mamba selective scan, and xLSTM's mLSTM (chunkwise) and
sLSTM (sequential) blocks. Functional like the reference: ``init_*``
returns a dict of tensors (each with the leading axes ``lead``, the
stacked periods), ``apply_*`` takes (params, activations).

Activations are ``(..., S, d)``. A weight of the dense attention may carry
one extra leading client axis ``C`` (the LM task's per-client merged query
projection); activations are then ``(C, n, S, d)`` and the product runs as
a batched matmul over ``C``. The MLA, MoE, Mamba and xLSTM layers take
``(B, S, d)`` only. Under a model mesh the attention and the dense FFN take
one batch shard ``(B, S, d)`` and weights whose split leaves are
:class:`~repro_torch.models.dist.Ranks` (``launch.sharded.view``).

The MoE dispatch, the Mamba scan, the mLSTM chunk scan and the sLSTM
recurrence are plain PyTorch, as the reference's are plain ``jnp`` and
``lax.scan`` code (no Pallas kernel); the attention inside MLA goes through
the flash kernels.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.dist import Ranks, gathered, join_cat, join_sum

PyTree = Any


def dense_init(generator: torch.Generator, shape, in_axis_size: int) -> torch.Tensor:
    """normal / sqrt(fan-in), drawn on the generator's device and scaled in
    place (no second copy of the leaf: deepseek's expert stacks are 4.8 G
    elements each)."""
    scale = 1.0 / math.sqrt(max(in_axis_size, 1))
    return torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32).mul_(scale)


def _full(generator: torch.Generator, shape, value: float) -> torch.Tensor:
    return torch.full(shape, value, dtype=torch.float32, device=generator.device)


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


def project_cols(x: torch.Tensor, w, device: torch.device) -> torch.Tensor:
    """``x (..., d) @ w (d, n)``; for ``w`` as :class:`Ranks` of column
    blocks, each rank's product joined in rank order (a block may straddle
    a cut the caller makes later, as MLA's latent/rope and the halves of
    Mamba's and the mLSTM's up projections)."""
    if isinstance(w, Ranks):
        return join_cat([x.to(wm.device) @ wm for wm in w], device, -1)
    return x @ w


def project_rows(x: torch.Tensor, w, device: torch.device) -> torch.Tensor:
    """``x (..., n) @ w (n, d)``; for ``w`` as :class:`Ranks` of row blocks,
    each rank's rows against ``x``'s matching columns, the partial sums
    joined in rank order."""
    if not isinstance(w, Ranks):
        return x @ w
    n = w[0].shape[0]
    return join_sum([x[..., m * n: (m + 1) * n].to(wm.device) @ wm for m, wm in enumerate(w)], device)


# ---------------------------------------------------------------- norms
def init_rmsnorm(d: int, device, lead=()) -> PyTree:
    return {"scale": torch.zeros((*lead, d), dtype=torch.float32, device=device)}  # gemma-style (1 + scale)


def rms_norm(params: PyTree, x: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * (1.0 + params["scale"].to(torch.float32))).to(x.dtype)


# ------------------------------------------------------- rotary embeddings
def rope_tables(positions: torch.Tensor, hd: int, theta: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The rotation's ``(cos, sin)``, each ``(S, 1, hd / 2)``: angles in
    fp32, as the reference computes them."""
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=device) / half)
    angles = positions[..., None].to(torch.float32) * freq  # (S, half)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, hd) rotated by halves (not interleaved)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd), rotated by halves; positions (S,)."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta, x.device))


# --------------------------------------------------------------- attention
def init_attention(generator: torch.Generator, cfg: ModelConfig, lead=()) -> PyTree:
    """wq (d, H, hd), wk/wv (d, KV, hd), wo (H, hd, d), each with the
    leading axes ``lead`` (the stacked periods). MLA: wq (d, H, nope +
    rope), w_dkv (d, lora + rope), w_ukv (lora, H, nope + v), wo (H, v, d)
    and the latent's ``kv_norm``."""
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    if cfg.mla is not None:
        m = cfg.mla
        return {
            "wq": dense_init(generator, (*lead, d, H, m.qk_nope_head_dim + m.qk_rope_head_dim), d),
            "w_dkv": dense_init(generator, (*lead, d, m.kv_lora_rank + m.qk_rope_head_dim), d),
            "w_ukv": dense_init(generator, (*lead, m.kv_lora_rank, H, m.qk_nope_head_dim + m.v_head_dim),
                                m.kv_lora_rank),
            "wo": dense_init(generator, (*lead, H, m.v_head_dim, d), H * m.v_head_dim),
            "kv_norm": init_rmsnorm(m.kv_lora_rank, generator.device, lead),
        }
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
    ``return_cache``, else ``(out, None)``. A config with MLA takes
    :func:`_apply_mla`."""
    from repro_torch.kernels import ops as K

    if cfg.mla is not None:
        return _apply_mla(params, x, cfg, cache=cache, pos0=pos0, return_cache=return_cache)
    if isinstance(params["wq"], Ranks):
        if cache is not None:
            raise ValueError("a context cache is not taken under a model mesh")
        return _apply_attention_ranks(params, x, cfg, local=local, pos0=pos0, return_cache=return_cache)
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


def rank_qkv(params: PyTree, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """Column-parallel projections of one batch shard: ``q`` as :class:`Ranks`
    of each rank's heads ``(B, S, H / tp, hd)``, rotated (the rotation's
    tables made once for every rank); ``k`` and ``v`` Ranks where the KV
    heads split, else projected once, whole."""
    tables = None if cfg.is_encoder else rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta, x.device)

    def rot(t: torch.Tensor) -> torch.Tensor:
        return t if tables is None else rotate(t, *(c.to(t.device) for c in tables))

    xs = [x.to(w.device) for w in params["wq"]]
    q = Ranks(rot(project(xm, w, 3)) for xm, w in zip(xs, params["wq"]))
    if isinstance(params["wk"], Ranks):
        k = Ranks(rot(project(xm, w, 3)) for xm, w in zip(xs, params["wk"]))
        v = Ranks(project(xm, w, 3) for xm, w in zip(xs, params["wv"]))
    else:
        k = rot(project(x, params["wk"], 3))
        v = project(x, params["wv"], 3)
    return q, k, v


def row_parallel(outs, wo: Ranks, device: torch.device) -> torch.Tensor:
    """Each rank's attention output ``(B, S, H / tp, dv)`` times its rows of
    ``wo``, the partial sums joined in rank order."""
    d = wo[0].shape[-1]
    return join_sum([o.reshape(*o.shape[:2], -1) @ w.reshape(-1, d) for o, w in zip(outs, wo)], device)


def _apply_attention_ranks(params: PyTree, x: torch.Tensor, cfg: ModelConfig, *, local: bool, pos0: int,
                           return_cache: bool):
    """:func:`apply_attention` on one batch shard ``(B, S, d)`` with the heads
    split over the model axis (Megatron's layout): each rank projects its
    heads, the flash kernel runs once a rank
    (:func:`repro_torch.kernels.ops.attention` on :class:`Ranks`), and each
    rank's output meets its rows of ``wo``; the partial sums join in rank
    order. The cache entries come back whole over the KV heads."""
    from repro_torch.kernels import ops as K

    S = x.shape[-2]
    q, k, v = rank_qkv(params, x, cfg, pos0 + torch.arange(S, device=x.device))
    heads_first = lambda t: Ranks(p.transpose(1, 2) for p in t) if isinstance(t, Ranks) else t.transpose(1, 2)  # noqa: E731
    out = K.attention(heads_first(q), heads_first(k), heads_first(v), causal=cfg.causal, scale=attention_scale(cfg),
                      window=cfg.sliding_window if local else None, softcap=cfg.attn_logit_softcap, q_pos0=pos0)
    mix = row_parallel([o.transpose(1, 2) for o in out], params["wo"], x.device)
    if not return_cache:
        return mix, None
    whole = lambda t: join_cat(t, x.device, 2) if isinstance(t, Ranks) else t  # noqa: E731
    return mix, {"k": whole(k), "v": whole(v)}


def _apply_mla(params: PyTree, x: torch.Tensor, cfg: ModelConfig, *, cache: PyTree | None, pos0: int,
               return_cache: bool):
    """DeepSeek-V2 multi-head latent attention, full sequence, through the
    flash kernels (head width nope + rope against value width v, scale
    ``(nope + rope) ** -0.5``). Keys and values come up from the 512-wide
    latent ``ckv`` (after ``kv_norm``); the one RoPE key ``krope`` is shared
    by every head. A ``cache`` (``{"ckv": (B, S_ctx, lora), "krope": (B,
    S_ctx, rope)}``) is prepended; ``return_cache`` returns this call's
    entries."""
    from repro_torch.kernels import ops as K

    if isinstance(params["wq"], Ranks):
        if cache is not None:
            raise ValueError("a context cache is not taken under a model mesh")
        return _apply_mla_ranks(params, x, cfg, pos0=pos0, return_cache=return_cache)
    m = cfg.mla
    S, d = x.shape[1], x.shape[2]
    nope = m.qk_nope_head_dim
    q = project(x, params["wq"], 3)  # (B, S, H, nope + rope)
    positions = pos0 + torch.arange(S, device=x.device)
    q_nope, q_rope = q[..., :nope], rope(q[..., nope:], positions, cfg.rope_theta)
    dkv = project(x, params["w_dkv"], 2)  # (B, S, lora + rope)
    ckv = rms_norm(params["kv_norm"], dkv[..., : m.kv_lora_rank], cfg.norm_eps)
    k_rope = rope(dkv[..., m.kv_lora_rank:][:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    new_entries = {"ckv": ckv, "krope": k_rope}
    if cache is not None:
        ckv = torch.cat([cache["ckv"], ckv], dim=1)
        k_rope = torch.cat([cache["krope"], k_rope], dim=1)
    ukv = project(ckv, params["w_ukv"], 3)  # (B, S_ctx, H, nope + v)
    k_nope, v = ukv[..., :nope], ukv[..., nope:]
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(*k_nope.shape[:3], m.qk_rope_head_dim)], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    out = K.attention(q_full.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=cfg.causal,
                      scale=(nope + m.qk_rope_head_dim) ** -0.5, q_pos0=pos0)  # (B, H, S, v)
    out = out.transpose(1, 2).reshape(x.shape[0], S, -1) @ params["wo"].reshape(-1, d)
    return out, (new_entries if return_cache else None)


def _apply_mla_ranks(params: PyTree, x: torch.Tensor, cfg: ModelConfig, *, pos0: int, return_cache: bool):
    """:func:`_apply_mla` on one batch shard with the heads split over the
    model axis: ``w_dkv``'s column blocks joined in rank order into the
    whole latent before ``kv_norm`` and the RoPE key are cut at
    ``kv_lora_rank`` (a block may straddle that cut); each rank projects its
    query heads and up-projects the latent into its keys and values; the
    flash forward kernel runs once a rank (head width nope + rope, value
    width v); ``wo`` is row-parallel, the partial sums joined in rank order.
    The cache entries are the whole latent and RoPE key."""
    from repro_torch.kernels import ops as K

    m = cfg.mla
    S, dev = x.shape[1], x.device
    nope, rope_dim = m.qk_nope_head_dim, m.qk_rope_head_dim
    positions = pos0 + torch.arange(S, device=dev)
    dkv = project_cols(x, params["w_dkv"], dev)  # (B, S, lora + rope)
    ckv = rms_norm(params["kv_norm"], dkv[..., : m.kv_lora_rank], cfg.norm_eps)
    k_rope = rope(dkv[..., m.kv_lora_rank:][:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    tables = rope_tables(positions, rope_dim, cfg.rope_theta, dev)
    qs, ks, vs = [], [], []
    for wq, w_ukv in zip(params["wq"], params["w_ukv"]):
        dm = wq.device
        q = project(x.to(dm), wq, 3)  # (B, S, H / tp, nope + rope)
        q = torch.cat([q[..., :nope], rotate(q[..., nope:], *(t.to(dm) for t in tables))], dim=-1)
        ukv = project(ckv.to(dm), w_ukv, 3)  # (B, S, H / tp, nope + v)
        k_nope = ukv[..., :nope]
        k = torch.cat([k_nope, k_rope.to(dm)[:, :, None, :].expand(*k_nope.shape[:3], rope_dim)], dim=-1)
        qs.append(q.transpose(1, 2))
        ks.append(k.transpose(1, 2))
        vs.append(ukv[..., nope:].transpose(1, 2))
    out = K.attention(Ranks(qs), Ranks(ks), Ranks(vs), causal=cfg.causal, scale=(nope + rope_dim) ** -0.5,
                      q_pos0=pos0)
    mix = row_parallel([o.transpose(1, 2) for o in out], params["wo"], dev)
    return mix, ({"ckv": ckv, "krope": k_rope} if return_cache else None)


# -------------------------------------------------------------- dense FFN
def init_dense_ffn(generator: torch.Generator, d: int, d_ff: int, lead=()) -> PyTree:
    return {
        "wg": dense_init(generator, (*lead, d, d_ff), d),
        "wu": dense_init(generator, (*lead, d, d_ff), d),
        "wd": dense_init(generator, (*lead, d_ff, d), d_ff),
    }


def apply_dense_ffn(params: PyTree, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU. Under a model mesh (``wg``, ``wu`` as :class:`Ranks` of
    column blocks, ``wd`` of the matching row blocks) each rank computes its
    slice of the hidden width and the partial sums join in rank order."""
    if isinstance(params["wg"], Ranks):
        partials = []
        for wg, wu, wd in zip(params["wg"], params["wu"], params["wd"]):
            xm = x.to(wg.device)
            partials.append((torch.nn.functional.silu(xm @ wg) * (xm @ wu)) @ wd)
        return join_sum(partials, x.device)
    gate = torch.nn.functional.silu(x @ params["wg"])
    up = x @ params["wu"]
    return (gate * up) @ params["wd"]


# -------------------------------------------------------------------- MoE
def init_moe_ffn(generator: torch.Generator, cfg: ModelConfig, lead=()) -> PyTree:
    """router (d, E) (fp32 in the reference too), expert stacks wg/wu
    (E, d, de) and wd (E, de, d), and the shared experts as one dense FFN
    of width ``num_shared * de``."""
    moe = cfg.moe
    d, de, E = cfg.d_model, moe.d_expert, moe.num_experts
    p = {
        "router": dense_init(generator, (*lead, d, E), d),
        "wg": dense_init(generator, (*lead, E, d, de), d),
        "wu": dense_init(generator, (*lead, E, d, de), d),
        "wd": dense_init(generator, (*lead, E, de, d), de),
    }
    if moe.num_shared:
        p["shared"] = init_dense_ffn(generator, d, moe.num_shared * de, lead)
    return p


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``'s order along the last axis: the larger value first,
    ties to the lower index (a stable descending sort; ``torch.topk``
    promises no order among ties)."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _route(probs: torch.Tensor, cfg: ModelConfig, capacity_factor: float):
    """The reference's routing of ``n`` groups of ``g`` tokens from the
    router's fp32 softmax ``probs (n, g, E)``: each (token, k) pair's expert
    and normalised weight ``(n, g K)`` in ``lax.top_k``'s order, its place
    in the expert's queue (token-major, then k) and whether it is kept
    (place below ``C``); ``C`` and the Switch aux loss, ``density`` counting
    the pairs before the drop. Returns ``(expert, weight, slot, keep, C,
    aux)``."""
    n, g, E = probs.shape
    K = cfg.moe.top_k
    C = g if cfg.moe_dropless else max(1, int(math.ceil(K * g * capacity_factor / E)))
    topw, topi = top_k(probs, K)  # (n, g, K)
    topw = topw / (torch.sum(topw, dim=-1, keepdim=True) + 1e-9)
    onehot = torch.nn.functional.one_hot(topi, E)  # (n, g, K, E)
    flat = onehot.reshape(n, g * K, E)
    expert = topi.reshape(n, g * K)
    slot = (torch.cumsum(flat, dim=1) - flat).gather(-1, expert[..., None])[..., 0]  # place in the expert's queue
    density = torch.mean(torch.sum(onehot.to(torch.float32), dim=2), dim=1)  # (n, E)
    aux = E * torch.mean(torch.sum(density * torch.mean(probs, dim=1), dim=-1)) / K
    return expert, topw.reshape(n, g * K), slot, slot < C, C, aux


def apply_moe_ffn(params: PyTree, x: torch.Tensor, cfg: ModelConfig, capacity_factor: float = 1.25,
                  group_size: int = 4096) -> tuple[torch.Tensor, torch.Tensor]:
    """GShard-style top-k MoE over ``x (B, S, d)``; returns ``(y, aux)``.

    The reference's rules, one for one: the ``T = B S`` tokens go in groups
    of ``g = min(group_size, T)``; the router's softmax in fp32, each
    token's top-k experts in ``lax.top_k``'s order, their weights divided
    by ``sum + 1e-9``; an expert takes ``C = ceil(K g cf / E)`` pairs of a
    group (``C = g`` with ``cfg.moe_dropless``), and a (token, k) pair's
    slot is its place in the expert's queue counted token-major, then k;
    pairs at or past ``C`` are dropped (their token keeps the residual).
    Tokens past the last whole group get zero output. ``aux`` is the
    Switch load-balancing loss ``E mean(sum(density router_prob)) / K``,
    with ``density`` counting the routed pairs before the drop.

    Dispatch gathers the kept tokens into an ``(n, E, C, d)`` buffer (a
    dropped pair writes to a spare slot ``C`` that is cut off): the same
    values as the reference's one-hot ``dispatch`` einsum, exactly. The
    expert FFN runs on the whole buffer, as the reference's. The combine
    sums each token's K rows, weighted, over k in order (the reference
    contracts over all ``E C`` slots, most of them zero weights): the same
    terms, rounded in another order."""
    moe = cfg.moe
    B, S, D = x.shape
    E, K = moe.num_experts, moe.top_k
    T = B * S
    g = min(group_size, T)
    n = T // g
    xg = x.reshape(T, D)[: n * g].reshape(n, g, D)
    logits = (xg @ params["router"].to(xg.dtype)).to(torch.float32)
    expert, topw, slot, keep, C, aux = _route(torch.softmax(logits, dim=-1), cfg, capacity_factor)
    slot = torch.where(keep, slot, C)
    group = torch.arange(n, device=x.device)[:, None].expand(n, g * K)
    token = torch.arange(g * K, device=x.device) // K
    expert_in = xg.new_zeros((n, E, C + 1, D)).index_put((group, expert, slot), xg[:, token])[:, :, :C]
    h = torch.nn.functional.silu(expert_in @ params["wg"]) * (expert_in @ params["wu"])
    expert_out = h @ params["wd"]  # (n, E, C, d)
    rows = expert_out[group, expert, slot.clamp(max=C - 1)]  # (n, g K, d)
    w = (topw * keep).to(rows.dtype)
    out = (rows * w[..., None]).reshape(n, g, K, D).sum(dim=2)

    out = out.reshape(n * g, D)
    if n * g < T:  # tokens past the last whole group
        out = torch.cat([out, out.new_zeros((T - n * g, D))], dim=0)
    y = out.reshape(B, S, D)
    if moe.num_shared:
        y = y + apply_dense_ffn(params["shared"], x)
    return y, aux


def apply_moe_ffn_shards(params: list[PyTree], xs: list[torch.Tensor], cfg: ModelConfig,
                         capacity_factor: float = 1.25, group_size: int = 4096) -> tuple[list[torch.Tensor], torch.Tensor]:
    """:func:`apply_moe_ffn` over the batch shards of one step together:
    ``xs[b] (B_b, S, d)`` is shard b's rows, ``params[b]`` its view of the
    layer; returns each shard's output and the one aux loss (on the first
    shard's device). One shard with whole weights is
    :func:`apply_moe_ffn` itself.

    The routing follows the reference's groups over the **whole** batch:
    each shard's router probabilities (the router replicated) are joined in
    shard order, so the ``g = min(group_size, T)`` tokens of a group run in
    token order across the shards; the top-k choices, each expert's
    capacity ``C``, the pairs' queue places, the drops and the aux loss's
    density and router probability come from the group, as without a mesh.
    Then each shard dispatches only its own kept pairs into an ``(E, C_s,
    d)`` buffer (``C_s`` the most kept pairs an expert takes from one shard,
    read once a layer) and combines its own tokens. An expert's rows are
    independent, so where in the buffer a pair sits does not change its
    output. Where ``wg``/``wu`` split over the experts (:class:`Ranks` of
    expert groups: expert parallelism) each rank runs its experts' gate and
    up products on its part of the buffer and their ``h`` join over the
    experts in rank order for the whole ``wd`` (a ``wd`` split on the period
    dim comes whole from the rank that holds it). The shared experts take
    :func:`apply_dense_ffn`."""
    if len(xs) == 1 and not isinstance(params[0]["wg"], Ranks):
        y, aux = apply_moe_ffn(params[0], xs[0], cfg, capacity_factor, group_size)
        return [y], aux
    moe = cfg.moe
    E, K = moe.num_experts, moe.top_k
    dev, D = xs[0].device, xs[0].shape[-1]
    sizes = [x.shape[0] * x.shape[1] for x in xs]
    T = sum(sizes)
    g = min(group_size, T)
    n = T // g
    probs = join_cat([torch.softmax((x.reshape(-1, D) @ p["router"].to(x.dtype)).to(torch.float32), dim=-1)
                      for p, x in zip(params, xs)], dev, 0)[: n * g].reshape(n, g, E)
    expert, topw, _, keep, capacity, aux = _route(probs, cfg, capacity_factor)
    keep = keep.reshape(n * g, K)
    expert = expert.reshape(n * g, K)
    weight = topw.reshape(n * g, K) * keep

    # each shard's kept pairs, token-major then k, placed in its experts' queues
    counts = _token_splits(sizes, n * g)
    shards = []
    for x, e, k in zip(xs, expert.split(counts), keep.split(counts)):
        e, k = e.to(x.device).reshape(-1), k.to(x.device).reshape(-1)
        mine = torch.nn.functional.one_hot(e, E) * k[:, None]
        place = (torch.cumsum(mine, dim=0) - mine).gather(-1, e[:, None])[:, 0]
        shards.append((e, k, place, torch.sum(mine, dim=0)))
    if dev.type == "meta":  # shapes only (the dry-run): an expert's most, its capacity
        width = capacity
    else:
        width = max(1, int(torch.stack([s[3].to(dev) for s in shards]).max()))  # C_s: one read a layer

    ys = []
    for p, x, t, (e, k, place, _), w in zip(params, xs, counts, shards, weight.split(counts)):
        xt = x.reshape(-1, D)
        out = []
        if t:
            spot = torch.where(k, place, width)
            token = torch.arange(t * K, device=x.device) // K
            buf = xt.new_zeros((E, width + 1, D)).index_put((e, spot), xt[token])[:, :width]
            if isinstance(p["wg"], Ranks):  # expert parallel: each rank its experts, h joined over them in rank order
                per = E // len(p["wg"])
                hs = []
                for r, (wg, wu) in enumerate(zip(p["wg"], p["wu"])):
                    part = buf[r * per: (r + 1) * per].to(wg.device)
                    hs.append(torch.nn.functional.silu(part @ wg) * (part @ wu))
                h = join_cat(hs, x.device, 0)
            else:
                h = torch.nn.functional.silu(buf @ p["wg"]) * (buf @ p["wu"])
            rows = (h @ p["wd"])[e, spot.clamp(max=width - 1)]  # (t K, d)
            out.append((rows * w.to(x.device).reshape(-1)[:, None].to(rows.dtype)).reshape(t, K, D).sum(dim=1))
        if t < xt.shape[0]:  # tokens past the last whole group
            out.append(xt.new_zeros((xt.shape[0] - t, D)))
        y = torch.cat(out).reshape(x.shape)
        if moe.num_shared:
            y = y + apply_dense_ffn(p["shared"], x)
        ys.append(y)
    return ys, aux


def _token_splits(sizes: list[int], inside: int) -> list[int]:
    """How many of the first ``inside`` tokens (those in whole groups) each
    shard of ``sizes`` tokens holds, in shard order."""
    out, start = [], 0
    for size in sizes:
        out.append(min(size, max(0, inside - start)))
        start += size
    return out


# ------------------------------------------------------------------ Mamba
def init_mamba(generator: torch.Generator, cfg: ModelConfig, lead=()) -> PyTree:
    """The selective SSM: in projection (x, z), depthwise causal conv, the
    low-rank dt projection (rank ``max(16, d // 16)``), ``dt_bias`` -4.6
    (softplus^-1(0.01)), ``A_log = log(1..d_state)``, ``D`` ones (the last
    two fp32), out projection."""
    mb = cfg.mamba
    d = cfg.d_model
    di, ds, dc = mb.d_inner(d), mb.d_state, mb.d_conv
    dt_rank = max(16, d // 16)
    A = torch.log(torch.arange(1, ds + 1, dtype=torch.float32, device=generator.device))
    return {
        "w_in": dense_init(generator, (*lead, d, 2 * di), d),
        "conv_w": dense_init(generator, (*lead, dc, di), dc),
        "conv_b": _full(generator, (*lead, di), 0.0),
        "w_x": dense_init(generator, (*lead, di, dt_rank + 2 * ds), di),
        "w_dt": dense_init(generator, (*lead, dt_rank, di), dt_rank),
        "dt_bias": _full(generator, (*lead, di), -4.6),
        "A_log": A.expand(*lead, di, ds).clone(),
        "D": _full(generator, (*lead, di), 1.0),
        "w_out": dense_init(generator, (*lead, di, d), di),
    }


def _mamba_conv(params: PyTree, x_in: torch.Tensor, conv_state: torch.Tensor | None = None):
    """Causal depthwise conv over ``x_in (B, S, Di)`` after the carried
    ``conv_state (B, dc - 1, Di)`` (zeros without one); returns the output
    and the last ``dc - 1`` inputs."""
    dc = params["conv_w"].shape[0]
    if conv_state is None:
        pad = x_in.new_zeros((x_in.shape[0], dc - 1, x_in.shape[2]))
    else:
        pad = conv_state.to(x_in.dtype)
    xp = torch.cat([pad, x_in], dim=1)
    S = x_in.shape[1]
    out = sum(xp[:, i: i + S, :] * params["conv_w"][i][None, None, :] for i in range(dc))
    return out + params["conv_b"][None, None, :], xp[:, -(dc - 1):, :]


def _mamba_ssm_inputs(params: PyTree, xc: torch.Tensor, mb, proj: torch.Tensor | None = None):
    """The discretized ``dA = exp(dt A)``, ``dBx = dt B x`` ``(B, S, Di,
    ds)`` and ``C (B, S, ds)``, in fp32; ``dt = softplus(x W_x W_dt +
    dt_bias)``. ``proj`` is ``xc @ W_x`` where it comes joined from the
    model ranks' partial sums; else it is computed here."""
    dt_rank = params["w_dt"].shape[0]
    ds = mb.d_state
    proj = xc @ params["w_x"] if proj is None else proj
    dt_r, Bs, Cs = proj[..., :dt_rank], proj[..., dt_rank: dt_rank + ds], proj[..., dt_rank + ds:]
    pre = (dt_r @ params["w_dt"]).to(torch.float32) + params["dt_bias"].to(torch.float32)
    dt = torch.logaddexp(pre, torch.zeros((), device=pre.device))  # softplus, as jax.nn.softplus computes it
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt[..., None] * A[None, None])
    dBx = dt[..., None] * Bs[:, :, None, :].to(torch.float32) * xc[..., None].to(torch.float32)
    return dA, dBx, Cs.to(torch.float32)


def associative_scan(fn, elems: list[torch.Tensor], dim: int) -> list[torch.Tensor]:
    """Inclusive scan of ``elems`` along ``dim`` under the associative
    ``fn`` (lists of tensors in and out), combining in
    ``lax.associative_scan``'s order: adjacent pairs, the scan of those by
    recursion, then each even element from the odd one before it. The
    reference's Mamba chunk uses it; a sequential scan rounds otherwise."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def cut(t, start, stop=None, step=1):
        return t[(slice(None),) * dim + (slice(start, stop, step),)]

    odd = associative_scan(fn, fn([cut(e, 0, -1, 2) for e in elems], [cut(e, 1, None, 2) for e in elems]), dim)
    prev = [cut(o, 0, -1) for o in odd] if n % 2 == 0 else odd
    even = fn(prev, [cut(e, 2, None, 2) for e in elems])
    out = []
    for e, ev, od in zip(elems, even, odd):
        ev = torch.cat([cut(e, 0, 1), ev], dim=dim)
        pairs = torch.stack([cut(ev, 0, od.shape[dim]), od], dim=dim + 1).flatten(dim, dim + 1)
        out.append(pairs if n % 2 == 0 else torch.cat([pairs, cut(ev, -1)], dim=dim))
    return out


def _mamba_combine(a, b):
    return [a[0] * b[0], b[0] * a[1] + b[1]]


def _mamba_chunk(h_prev: torch.Tensor, dA: torch.Tensor, dBx: torch.Tensor, Cs: torch.Tensor):
    """One chunk of the selective scan from the state ``h_prev (B, Di,
    ds)``: the chunk's prefix products and sums by the associative scan,
    then ``h_t = prod_A h_prev + sum_B``; returns the last state and ``y (B,
    ck, Di)``."""
    pA, pB = associative_scan(_mamba_combine, [dA, dBx], 1)
    h_all = pA * h_prev[:, None] + pB
    return h_all[:, -1], torch.einsum("bcis,bcs->bci", h_all, Cs)


def _mamba_scan(params: PyTree, xc: torch.Tensor, mb, h: torch.Tensor, scan_chunk: int, decode: bool,
                proj: torch.Tensor | None = None):
    """The selective scan over the conv's output ``xc (B, S, Di)`` from the
    state ``h (B, Di, ds)``: one step in decode, else chunks of
    ``scan_chunk`` and a ragged tail; returns the last state and ``y (B, S,
    Di)`` before the skip. ``proj`` as :func:`_mamba_ssm_inputs` takes it."""
    cut = (lambda a, b: None) if proj is None else (lambda a, b: proj[:, a:b])  # noqa: E731
    if decode:
        dA, dBx, Cs = _mamba_ssm_inputs(params, xc, mb, proj)
        h = h * dA[:, 0] + dBx[:, 0]
        return h, torch.einsum("bis,bs->bi", h, Cs[:, 0])[:, None, :]
    S = xc.shape[1]
    ck = min(scan_chunk, S)
    n = S // ck
    dA, dBx, Cs = _mamba_ssm_inputs(params, xc[:, : n * ck], mb, cut(0, n * ck))
    ys = []
    for i in range(n):
        part = slice(i * ck, (i + 1) * ck)
        h, y_c = _mamba_chunk(h, dA[:, part], dBx[:, part], Cs[:, part])
        ys.append(y_c)
    if n * ck < S:  # ragged tail
        h, y_c = _mamba_chunk(h, *_mamba_ssm_inputs(params, xc[:, n * ck:], mb, cut(n * ck, S)))
        ys.append(y_c)
    return h, torch.cat(ys, dim=1)


def apply_mamba(params: PyTree, x: torch.Tensor, cfg: ModelConfig, *, cache: PyTree | None = None,
                scan_chunk: int = 256):
    """Mamba over ``x (B, S, d)``; returns ``(out, {"conv": (B, dc - 1,
    Di), "ssm": (B, Di, ds)})``. A decode step (``cache`` given and ``S ==
    1``) advances the state once; otherwise the scan runs in chunks of
    ``scan_chunk`` (a Python loop over the reference's ``lax.scan``), a
    ragged tail as one more chunk, from the cache's state or zeros. Under a
    model mesh with ``d_inner`` split (:class:`Ranks`) see
    :func:`_apply_mamba_ranks`."""
    if isinstance(params["conv_w"], Ranks):
        return _apply_mamba_ranks(params, x, cfg, cache=cache, scan_chunk=scan_chunk)
    mb = cfg.mamba
    B, S, _ = x.shape
    xz = x @ params["w_in"]
    x_in, z = xz.chunk(2, dim=-1)
    xc, conv_state = _mamba_conv(params, x_in, cache["conv"] if cache else None)
    xc = torch.nn.functional.silu(xc)
    h = cache["ssm"] if cache else torch.zeros((B, x_in.shape[-1], mb.d_state), device=x.device)
    h, y = _mamba_scan(params, xc, mb, h, scan_chunk, cache is not None and S == 1)
    y = y.to(x.dtype) + params["D"].to(x.dtype)[None, None, :] * xc
    out = (y * torch.nn.functional.silu(z)) @ params["w_out"]
    return out, {"conv": conv_state, "ssm": h}


def _apply_mamba_ranks(params: PyTree, x: torch.Tensor, cfg: ModelConfig, *, cache: PyTree | None,
                       scan_chunk: int):
    """:func:`apply_mamba` on one batch shard with ``d_inner`` split over the
    model axis. ``w_in``'s column blocks join in rank order and ``x_in``,
    ``z`` are cut from the whole (with 2 Di split in tp blocks, the lower
    ranks hold ``x_in``, the upper ``z``: rank m's channels of either sit
    in another rank's block). The conv, ``dt``, the scan and the skip run
    on each rank's channels; ``w_x`` is row-parallel, its partial sums
    joined in rank order before ``dt``, ``B`` and ``C`` are cut; ``w_dt``
    is column-parallel and ``w_out`` row-parallel. The cache's channels
    join in rank order."""
    mb = cfg.mamba
    B, S, _ = x.shape
    dev = x.device
    x_in, z = project_cols(x, params["w_in"], dev).chunk(2, dim=-1)
    tp = len(params["conv_w"])
    n = x_in.shape[-1] // tp
    local = [{k: params[k][m] for k in ("conv_w", "conv_b", "w_dt", "dt_bias", "A_log", "D")} for m in range(tp)]
    chans = [slice(m * n, (m + 1) * n) for m in range(tp)]
    xcs, convs = [], []
    for pm, ch in zip(local, chans):
        dm = pm["conv_w"].device
        xc, conv = _mamba_conv(pm, x_in[..., ch].to(dm), cache["conv"][..., ch].to(dm) if cache else None)
        xcs.append(torch.nn.functional.silu(xc))
        convs.append(conv)
    proj = join_sum([xc @ w for xc, w in zip(xcs, params["w_x"])], dev)
    outs, states = [], []
    for pm, ch, xc, w_out in zip(local, chans, xcs, params["w_out"]):
        dm = xc.device
        h = cache["ssm"][:, ch].to(dm) if cache else torch.zeros((B, n, mb.d_state), device=dm)
        h, y = _mamba_scan(pm, xc, mb, h, scan_chunk, cache is not None and S == 1, proj.to(dm))
        y = y.to(x.dtype) + pm["D"].to(x.dtype)[None, None, :] * xc
        outs.append((y * torch.nn.functional.silu(z[..., ch].to(dm))) @ w_out)
        states.append(h)
    return join_sum(outs, dev), {"conv": join_cat(convs, dev, -1), "ssm": join_cat(states, dev, 1)}


# ------------------------------------------------------------------ mLSTM
def init_mlstm(generator: torch.Generator, cfg: ModelConfig, lead=()) -> PyTree:
    """Up projection (x, z) to ``di = d mlstm_proj_factor``, block-diagonal
    per-head q/k/v ``(h, hd, hd)``, fp32 input and forget gates (forget
    bias 3.0), the output norm and the down projection."""
    d = cfg.d_model
    di = int(d * cfg.mlstm_proj_factor)
    h = cfg.num_heads
    hd = di // h
    return {
        "w_up": dense_init(generator, (*lead, d, 2 * di), d),
        "wq": dense_init(generator, (*lead, h, hd, hd), hd),
        "wk": dense_init(generator, (*lead, h, hd, hd), hd),
        "wv": dense_init(generator, (*lead, h, hd, hd), hd),
        "w_i": dense_init(generator, (*lead, di, h), di),
        "w_f": dense_init(generator, (*lead, di, h), di),
        "f_bias": _full(generator, (*lead, h), 3.0),
        "out_norm": init_rmsnorm(di, generator.device, lead),
        "w_down": dense_init(generator, (*lead, di, d), di),
    }


def _mlstm_chunk(carry, qc, kc, vc, ic, fc):
    """One chunk of the stabilized mLSTM (the reference's ``chunk_step``,
    expression for expression): inside the chunk attention-style with
    gate-derived decay masks (``-inf`` above the diagonal, the stabilizer
    at least ``-1e30``), the carried ``(C, n, m)`` read through the inter
    weights; returns the carry at the chunk's end and the outputs."""
    C, n, m = carry
    ck = qc.shape[1]
    fcum = torch.cumsum(fc, dim=1)  # (B, ck, h)
    log_inter = m[:, None, :] + fcum
    log_intra = fcum[:, :, None, :] - fcum[:, None, :, :] + ic[:, None, :, :]  # (B, t, s, h)
    tri = torch.tril(torch.ones((ck, ck), dtype=torch.bool, device=fc.device))
    log_intra = torch.where(tri[None, :, :, None], log_intra, torch.full((), -math.inf, device=fc.device))
    m_new = torch.maximum(log_inter, torch.amax(log_intra, dim=2))
    m_new = torch.clamp_min(m_new, -1e30)
    inter_w = torch.exp(log_inter - m_new)
    intra_w = torch.exp(log_intra - m_new[:, :, None, :])
    qf, kf, vf = qc.to(torch.float32), kc.to(torch.float32), vc.to(torch.float32)
    o_inter = torch.einsum("bth,bhkl,bthk->bthl", inter_w, C, qf)
    n_inter = torch.einsum("bth,bhk,bthk->bth", inter_w, n, qf)
    s_intra = torch.einsum("bthk,bshk->btsh", qf, kf)
    o_intra = torch.einsum("btsh,btsh,bshl->bthl", intra_w, s_intra, vf)
    n_intra = torch.einsum("btsh,btsh->bth", intra_w, s_intra)
    denom = torch.maximum(torch.abs(n_inter + n_intra), torch.exp(-m_new)) + 1e-6
    out = (o_inter + o_intra) / denom[..., None]
    ftot = fcum[:, -1, :]
    m_next = torch.maximum(m + ftot, torch.amax(fcum[:, -1:, :] - fcum + ic, dim=1))
    decay_keep = torch.exp(m + ftot - m_next)
    kv_w = torch.exp(ftot[:, None, :] - fcum + ic - m_next[:, None, :])
    C_next = decay_keep[..., None, None] * C + torch.einsum("bsh,bshk,bshl->bhkl", kv_w, kf, vf)
    n_next = decay_keep[..., None] * n + torch.einsum("bsh,bshk->bhk", kv_w, kf)
    return (C_next, n_next, m_next), out


def apply_mlstm(params: PyTree, x: torch.Tensor, cfg: ModelConfig, *, cache: PyTree | None = None,
                chunk: int = 64):
    """Chunkwise-parallel mLSTM over ``x (B, S, d)``; returns ``(out, {"C":
    (B, h, hd, hd), "n": (B, h, hd), "m": (B, h)})``, all fp32. Chunks of
    ``chunk`` in a Python loop (the reference's ``lax.scan``), a ragged
    tail as one more chunk; from the cache's state, else ``C = n = 0`` and
    ``m = -1e30``. A decode step is a chunk of one.

    Under a model mesh (``d_inner`` split, :class:`Ranks`): ``w_up``'s
    column blocks join in rank order before ``x_in`` and ``z`` are cut (the
    lower ranks hold ``x_in``); ``wq``, ``wk``, ``wv`` (cut on their input
    dim inside each head's block), ``w_i``, ``w_f`` and ``w_down`` are
    row-parallel, their partial sums joined in rank order. The chunk scan
    runs whole on the shard (its few heads are not split), so ``out_norm``
    normalizes the whole ``d_inner`` vector on the shard's device, as
    without a mesh: the RMS needs every channel's square, and the vector is
    there already."""
    B, S, d = x.shape
    dev = x.device
    h = cfg.num_heads
    x_in, z = project_cols(x, params["w_up"], dev).chunk(2, dim=-1)
    di = x_in.shape[-1]
    hd = di // h
    xh = x_in.reshape(B, S, h, hd)

    def heads(w):
        """The block-diagonal per-head product; for ``w`` split over the model
        axis on its input dim, each rank's partial product inside every
        head, joined in rank order."""
        if not isinstance(w, Ranks):
            return torch.einsum("bshk,hkl->bshl", xh, w)
        n = w[0].shape[1]
        return join_sum([torch.einsum("bshk,hkl->bshl", xh[..., m * n: (m + 1) * n].to(wm.device), wm)
                         for m, wm in enumerate(w)], dev)

    q = heads(params["wq"]) * (hd ** -0.5)
    k = heads(params["wk"])
    v = heads(params["wv"])
    xf = x_in.to(torch.float32)
    i_log = project_rows(xf, params["w_i"], dev)  # (B, S, h)
    f_log = torch.nn.functional.logsigmoid(project_rows(xf, params["w_f"], dev) + params["f_bias"])
    if cache is None:
        carry = (torch.zeros((B, h, hd, hd), device=x.device), torch.zeros((B, h, hd), device=x.device),
                 torch.full((B, h), -1e30, device=x.device))
    else:
        carry = (cache["C"], cache["n"], cache["m"])
    ck = min(chunk, S)
    outs = []
    for start in range(0, S, ck):  # whole chunks, then the ragged tail
        part = slice(start, min(start + ck, S))
        carry, out = _mlstm_chunk(carry, q[:, part], k[:, part], v[:, part], i_log[:, part], f_log[:, part])
        outs.append(out)
    out = torch.cat(outs, dim=1).reshape(B, S, di).to(x.dtype)
    out = rms_norm(params["out_norm"], out, cfg.norm_eps) * torch.nn.functional.silu(z)
    return project_rows(out, params["w_down"], dev), {"C": carry[0], "n": carry[1], "m": carry[2]}


# ------------------------------------------------------------------ sLSTM
def init_slstm(generator: torch.Generator, cfg: ModelConfig, lead=()) -> PyTree:
    """Input and recurrent gate weights in the gate-aligned ``(d, 4, d)``
    layout (i, f, z, o), fp32 gate biases (zero), and the block's GELU FFN
    (width ``d slstm_proj_factor``)."""
    d = cfg.d_model
    df = int(d * cfg.slstm_proj_factor)
    return {
        "wgx": dense_init(generator, (*lead, d, 4, d), d),
        "wgh": dense_init(generator, (*lead, d, 4, d), d),
        "gbias": _full(generator, (*lead, 4, d), 0.0),
        "ffn_up": dense_init(generator, (*lead, d, df), d),
        "ffn_down": dense_init(generator, (*lead, df, d), df),
    }


def apply_slstm(params: PyTree, x: torch.Tensor, cfg: ModelConfig, *, cache: PyTree | None = None):
    """Strictly sequential sLSTM with exponential gating and a stabilizer
    (one Python step a token; the recurrence runs through ``h``, so it has
    no parallel form), then the block's GELU (tanh) FFN, added. Returns
    ``(out, {"c", "n", "m", "h"})``, each ``(B, d)``: ``c``, ``n``, ``m``
    fp32 (``n`` starts at 1e-6), ``h`` in the input's dtype. Under a model
    mesh with the channels split and more than one token, the reference's
    channel-sharded ``shard_map`` form (:func:`_apply_slstm_ranks`); a
    decode step runs this recurrence on the joined leaves, as the
    reference's does."""
    if isinstance(params["wgx"], Ranks) and x.shape[1] > 1:
        return _apply_slstm_ranks(params, x, cfg, cache=cache)
    params = gathered(params, x.device)
    B, S, d = x.shape
    if cache is None:
        c = torch.zeros((B, d), device=x.device)
        n = torch.full((B, d), 1e-6, device=x.device)
        m = torch.zeros((B, d), device=x.device)
        h = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    else:
        c, n, m, h = cache["c"], cache["n"], cache["m"], cache["h"]
    gx = project(x, params["wgx"], 3)  # (B, S, 4, d)
    wh = params["wgh"].reshape(d, 4 * d)
    hs = []
    for t in range(S):
        gates = (gx[:, t] + (h @ wh).reshape(B, 4, d) + params["gbias"]).to(torch.float32)
        c, n, m, h_new = _slstm_step(gates, c, n, m)
        h = h_new.to(h.dtype)
        hs.append(h)
    out = torch.stack(hs, dim=1)
    up = torch.nn.functional.gelu(out @ params["ffn_up"], approximate="tanh")
    return out + up @ params["ffn_down"], {"c": c, "n": n, "m": m, "h": h}


def _slstm_step(gates: torch.Tensor, c, n, m):
    """One step of the stabilized exponential gating from the fp32 gates
    ``(B, 4, d)`` (i, f, z, o): the new ``c``, ``n``, ``m`` and ``h``."""
    i_l, f_l, z_l, o_l = gates.unbind(1)
    f_log = torch.nn.functional.logsigmoid(f_l)
    m_new = torch.maximum(f_log + m, i_l)
    i_g = torch.exp(i_l - m_new)
    f_g = torch.exp(f_log + m - m_new)
    c = f_g * c + i_g * torch.tanh(z_l)
    n = f_g * n + i_g
    return c, n, m_new, torch.sigmoid(o_l) * c / torch.clamp_min(n, 1e-6)


def _apply_slstm_ranks(params: PyTree, x: torch.Tensor, cfg: ModelConfig, *, cache: PyTree | None):
    """The reference's channel-sharded sLSTM (``shard_map`` over ``model``,
    ``repro/models/layers.py:632-661``) on one batch shard: rank m holds its
    channels of all four gates (``wgx``, ``wgh`` and ``gbias`` cut on their
    last dim) and its channels' ``c``, ``n``, ``m``; each step every rank
    reads the whole ``h``, and the ranks' new ``h`` join in rank order (the
    reference's ``all_gather``). The FFN runs on the joined output."""
    B, S, d = x.shape
    dev = x.device
    tp = len(params["wgx"])
    n_c = d // tp
    chans = [slice(m * n_c, (m + 1) * n_c) for m in range(tp)]
    devs = [w.device for w in params["wgx"]]
    if cache is None:
        c = [torch.zeros((B, n_c), device=dm) for dm in devs]
        n = [torch.full((B, n_c), 1e-6, device=dm) for dm in devs]
        m = [torch.zeros((B, n_c), device=dm) for dm in devs]
        h = torch.zeros((B, d), dtype=x.dtype, device=dev)
    else:
        c, n, m = ([cache[k][:, ch].to(dm) for ch, dm in zip(chans, devs)] for k in ("c", "n", "m"))
        h = cache["h"]
    gx = [project(x.to(dm), w, 3) for w, dm in zip(params["wgx"], devs)]  # (B, S, 4, d / tp)
    wh = [w.reshape(d, 4 * n_c) for w in params["wgh"]]
    hs = []
    for t in range(S):
        parts = []
        for r in range(tp):
            gates = (gx[r][:, t] + (h.to(devs[r]) @ wh[r]).reshape(B, 4, n_c) + params["gbias"][r]).to(torch.float32)
            c[r], n[r], m[r], h_r = _slstm_step(gates, c[r], n[r], m[r])
            parts.append(h_r.to(h.dtype))
        h = join_cat(parts, dev, -1)
        hs.append(h)
    out = torch.stack(hs, dim=1)
    up = torch.nn.functional.gelu(project_cols(out, params["ffn_up"], dev), approximate="tanh")
    state = {k: join_cat(v, dev, -1) for k, v in (("c", c), ("n", n), ("m", m))}
    return out + project_rows(up, params["ffn_down"], dev), {**state, "h": h}
