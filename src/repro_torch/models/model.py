"""Model assembly: init, full-sequence forward, prefill caches and the
fixed-buffer decode step for every architecture of the zoo (counterpart
of ``repro.models.model``).

The backbone is ``prefix`` (a list of unrolled layers) and then
``pattern`` × ``num_periods``. ``params["blocks"]`` keeps the reference's
layout — ``{"slot<i>": layer tree}`` with every leaf stacked over a
leading period axis ``P`` — and ``params["prefix"]`` is a list of layer
trees, so a flattened tree matches the reference's element by element; the
reference's ``lax.scan`` over periods is a Python loop here. Decode caches
are laid out the same way.

A layer is a mixer (``attn``, ``attn_local``, ``mamba``, ``mlstm``,
``slstm``; attention is MLA where the config has one) and an FFN
(``dense``, ``moe`` or ``none``, which has no ``norm2``). ``forward``
takes ``{"tokens": (B, S)}`` or ``{"embeds": (B, S, d)}`` (pixtral's and
hubert's frontend stubs; an encoder adds sinusoidal positions), or tokens
``(C, n, S)`` together with client-batched weights: ``embed (C, V, d)``
and, in ``blocks``, a per-client ``wq (P, C, d, H, hd)`` (the LM task's
merged deltas, dense attention only). Under a model mesh the step
functions call ``forward`` once a batch shard, with weights whose
model-split leaves are :class:`~repro_torch.models.dist.Ranks`
(``launch.sharded.view``): the embedding and the LM head split over the
vocabulary, the attention over the heads, the dense FFN over its width.
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.pytrees import tree_flatten_with_names, tree_map, tree_unflatten
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.dist import Ranks, join_cat, join_sum, kv_group

PyTree = Any


# ------------------------------------------------------------------ init
_MIXER_INIT = {"attn": L.init_attention, "attn_local": L.init_attention, "mamba": L.init_mamba,
               "mlstm": L.init_mlstm, "slstm": L.init_slstm}


def _init_layer(generator: torch.Generator, spec: LayerSpec, cfg: ModelConfig, device, lead) -> PyTree:
    """One layer's params (leaves with the leading axes ``lead``), drawn on
    the generator's device and moved to ``device``."""
    d = cfg.d_model
    moved = lambda tree: tree_map(lambda t: t.to(device), tree)  # noqa: E731
    p = {"norm1": L.init_rmsnorm(d, device, lead), "mixer": moved(_MIXER_INIT[spec.mixer](generator, cfg, lead))}
    if spec.ffn != "none":
        p["norm2"] = L.init_rmsnorm(d, device, lead)
        if spec.ffn == "dense":
            p["ffn"] = moved(L.init_dense_ffn(generator, d, cfg.d_ff, lead))
        else:
            p["ffn"] = moved(L.init_moe_ffn(generator, cfg, lead))
    if cfg.use_post_norm:
        p["post_norm1"] = L.init_rmsnorm(d, device, lead)
        if spec.ffn != "none":
            p["post_norm2"] = L.init_rmsnorm(d, device, lead)
    return p


# leaves the reference draws in fp32 whatever the params' dtype
FP32_LEAVES = frozenset({"router", "A_log", "D", "w_i", "w_f", "f_bias", "gbias"})


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None, dtype=torch.float32) -> PyTree:
    """Random weights from ``generator`` (drawn on its device, then moved to
    ``device``): embed normal / sqrt(d), norms zero (gemma-style 1 + scale),
    projections normal / sqrt(fan-in) (each scaled in place), the prefix
    layers, blocks stacked over periods, then an untied head ``(d, V)``
    where the config has one. Drawn in fp32, then each leaf cast to
    ``dtype`` but the reference's fp32 ones (:data:`FP32_LEAVES`), as the
    reference's ``init_params(cfg, key, dtype)``."""
    params = _init_params_f32(cfg, generator, device)
    if dtype == torch.float32:
        return params
    flat = [leaf if names[-1] in FP32_LEAVES else leaf.to(dtype) for names, leaf in tree_flatten_with_names(params)]
    return tree_unflatten(params, flat)


def _init_params_f32(cfg: ModelConfig, generator: torch.Generator, device) -> PyTree:
    device = generator.device if device is None else torch.device(device)
    embed = torch.randn((cfg.padded_vocab, cfg.d_model), generator=generator, device=generator.device)
    params: dict[str, Any] = {
        "embed": embed.mul_(1.0 / math.sqrt(cfg.d_model)).to(device),
        "final_norm": L.init_rmsnorm(cfg.d_model, device),
    }
    if cfg.prefix:
        params["prefix"] = [_init_layer(generator, spec, cfg, device, ()) for spec in cfg.prefix]
    if cfg.num_periods:
        params["blocks"] = {
            f"slot{i}": _init_layer(generator, spec, cfg, device, (cfg.num_periods,))
            for i, spec in enumerate(cfg.pattern)
        }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(generator, (cfg.d_model, cfg.padded_vocab), cfg.d_model).to(device)
    return params


# ---------------------------------------------------------------- caches
def _init_layer_cache(spec: LayerSpec, cfg: ModelConfig, batch: int, buf_len: int, lead, device, dtype) -> PyTree:
    """One layer's decode buffers: attention ``{"k", "v"}`` of ``(batch,
    buf_len, KV, hd)`` (MLA: ``{"ckv": (batch, buf_len, lora), "krope":
    (batch, buf_len, rope)}``); Mamba ``{"conv", "ssm"}``; mLSTM ``{"C",
    "n", "m"}`` (``m`` at -1e30); sLSTM ``{"c", "n", "m", "h"}`` (``n`` at
    1e-6). Recurrent states are fp32 whatever ``dtype``."""
    def zeros(*shape, dt=dtype):
        return torch.zeros((*lead, batch, *shape), dtype=dt, device=device)

    def full(value, *shape):
        return torch.full((*lead, batch, *shape), value, dtype=torch.float32, device=device)

    if spec.mixer in ("attn", "attn_local"):
        if cfg.mla is not None:
            return {"ckv": zeros(buf_len, cfg.mla.kv_lora_rank), "krope": zeros(buf_len, cfg.mla.qk_rope_head_dim)}
        return {"k": zeros(buf_len, cfg.num_kv_heads, cfg.resolved_head_dim),
                "v": zeros(buf_len, cfg.num_kv_heads, cfg.resolved_head_dim)}
    if spec.mixer == "mamba":
        di = cfg.mamba.d_inner(cfg.d_model)
        return {"conv": zeros(cfg.mamba.d_conv - 1, di), "ssm": zeros(di, cfg.mamba.d_state, dt=torch.float32)}
    if spec.mixer == "mlstm":
        h = cfg.num_heads
        hd = int(cfg.d_model * cfg.mlstm_proj_factor) // h
        return {"C": zeros(h, hd, hd, dt=torch.float32), "n": zeros(h, hd, dt=torch.float32), "m": full(-1e30, h)}
    if spec.mixer == "slstm":
        d = cfg.d_model
        return {"c": zeros(d, dt=torch.float32), "n": full(1e-6, d), "m": zeros(d, dt=torch.float32), "h": zeros(d)}
    raise ValueError(spec.mixer)


def init_cache(cfg: ModelConfig, batch: int, ctx_len: int, margin: int = 128, *, device="cpu",
               dtype=torch.float32) -> PyTree:
    """Fixed-size decode buffers for ``ctx_len`` context and ``margin``
    generated tokens (``_init_layer_cache``, length ``ctx_len + margin``):
    ``prefix`` a list, ``blocks`` per pattern slot stacked over periods
    like ``params["blocks"]``. ``len`` counts the valid tokens. It is a
    Python int here (the reference's is a device scalar): the decode step
    reads it as the write position without a host sync."""
    buf = ctx_len + margin
    cache: dict[str, Any] = {"len": int(ctx_len)}
    if cfg.prefix:
        cache["prefix"] = [_init_layer_cache(spec, cfg, batch, buf, (), device, dtype) for spec in cfg.prefix]
    if cfg.num_periods:
        cache["blocks"] = {
            f"slot{i}": _init_layer_cache(spec, cfg, batch, buf, (cfg.num_periods,), device, dtype)
            for i, spec in enumerate(cfg.pattern)
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
    causally, and a window layer masks ``q_pos - k_pos >= window``). MLA
    takes :func:`_mla_decode_absorbed`."""
    if cfg.mla is not None:
        return _mla_decode_absorbed(mp, h, cfg, cache, pos0)
    if isinstance(mp["wq"], Ranks):
        return _attn_decode_ranks(mp, h, cfg, local, cache, pos0)
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


def _attn_decode_ranks(mp: PyTree, h: torch.Tensor, cfg: ModelConfig, local: bool, cache: PyTree, pos0: int):
    """:func:`_attn_decode` on one batch shard with the heads split over the
    model axis: each rank projects its query heads, the new token's k and v
    (whole over the KV heads) go into the shard's buffers at ``pos0``, and
    each rank attends over its KV heads of the buffer (its block where the
    KV heads split, else its group, ``dist.kv_group``); the ranks' outputs
    meet their rows of ``wo`` and the partial sums join in rank order."""
    positions = pos0 + torch.arange(h.shape[1], device=h.device)
    q, k, v = L.rank_qkv(mp, h, cfg, positions)
    whole = lambda t: join_cat(t, h.device, 2) if isinstance(t, Ranks) else t  # noqa: E731
    k_buf, v_buf = cache["k"], cache["v"]
    k_buf[:, pos0: pos0 + h.shape[1]] = whole(k).to(k_buf.dtype)
    v_buf[:, pos0: pos0 + h.shape[1]] = whole(v).to(v_buf.dtype)
    heads, kv_heads = sum(p.shape[2] for p in q), k_buf.shape[2]
    outs = []
    for m, qm in enumerate(q):
        if isinstance(k, Ranks):
            kv0, n = m * k[m].shape[2], k[m].shape[2]
        else:
            kv0, n = kv_group(m, qm.shape[2], heads, kv_heads)
        kb = k_buf[:, :, kv0: kv0 + n].to(device=qm.device, dtype=h.dtype)
        vb = v_buf[:, :, kv0: kv0 + n].to(device=qm.device, dtype=h.dtype)
        outs.append(L.attention_scores_reference(
            qm, kb, vb, causal=True, scale=L.attention_scale(cfg), window=cfg.sliding_window if local else None,
            softcap=cfg.attn_logit_softcap, q_pos0=pos0))
    return L.row_parallel(outs, mp["wo"], h.device), {"k": k_buf, "v": v_buf}


def _embed_ranks(embed: Ranks, tokens: torch.Tensor) -> torch.Tensor:
    """The vocab-parallel lookup: rank m holds rows ``[m V / tp, (m + 1) V /
    tp)`` and looks up the tokens in its range (zeros elsewhere); the rows
    join by the rank-order sum, which is each token's one nonzero row."""
    vl = embed[0].shape[0]
    parts = []
    for m, e in enumerate(embed):
        local = tokens.to(e.device) - m * vl
        hit = (local >= 0) & (local < vl)
        rows = e[local.clamp(0, vl - 1)]
        parts.append(torch.where(hit[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device)))
    return join_sum(parts, tokens.device)


def _head(x: torch.Tensor, w, tied: bool) -> torch.Tensor:
    """The LM head: ``x @ embed.T`` (tied) or ``x @ lm_head``; split over the
    vocabulary under a model mesh, the ranks' logits concatenated in rank
    order."""
    if isinstance(w, Ranks):
        return join_cat([_head(x.to(wm.device), wm, tied) for wm in w], x.device, -1)
    return L.project(x, w.transpose(-1, -2) if tied else w, 2)


def _mla_decode_absorbed(mp: PyTree, h: torch.Tensor, cfg: ModelConfig, cache: PyTree, pos0: int):
    """One new token of MLA against the fixed-size latent buffers, with the
    up-projection absorbed: the query goes into the latent space (``q_nope
    @ w_uk``), scores read ``ckv`` and ``krope`` directly, and the
    attention-weighted latent comes back through ``w_uv``; the cache is
    never up-projected. The new ``ckv``/``krope`` are written at ``pos0``
    in place; slots past ``pos0`` are masked. Plain PyTorch, as the
    reference's ``_mla_decode_absorbed`` is plain ``jnp``."""
    m = cfg.mla
    nope = m.qk_nope_head_dim
    ranked = isinstance(mp["wq"], Ranks)
    positions = pos0 + torch.arange(h.shape[1], device=h.device)
    dkv = L.project_cols(h, mp["w_dkv"], h.device)
    ckv_new = L.rms_norm(mp["kv_norm"], dkv[..., : m.kv_lora_rank], cfg.norm_eps)
    krope_new = L.rope(dkv[..., m.kv_lora_rank:][:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    ckv_buf, krope_buf = cache["ckv"], cache["krope"]
    ckv_buf[:, pos0: pos0 + h.shape[1]] = ckv_new.to(ckv_buf.dtype)
    krope_buf[:, pos0: pos0 + h.shape[1]] = krope_new.to(krope_buf.dtype)
    tables = L.rope_tables(positions, m.qk_rope_head_dim, cfg.rope_theta, h.device)
    seen = (torch.arange(ckv_buf.shape[1], device=h.device) <= pos0)[None, None, None, :]
    if not ranked:
        out = _mla_absorbed_heads(mp["wq"], mp["w_ukv"], h, cfg, ckv_buf, krope_buf, tables, seen)
        out = out.reshape(*out.shape[:2], -1) @ mp["wo"].reshape(-1, h.shape[-1])
    else:  # each rank its heads against the whole buffers, wo row-parallel
        outs = []
        for wq, w_ukv in zip(mp["wq"], mp["w_ukv"]):
            dm = wq.device
            outs.append(_mla_absorbed_heads(wq, w_ukv, h.to(dm), cfg, ckv_buf.to(dm), krope_buf.to(dm),
                                            tuple(t.to(dm) for t in tables), seen.to(dm)))
        out = L.row_parallel(outs, mp["wo"], h.device)
    return out, {"ckv": ckv_buf, "krope": krope_buf}


def _mla_absorbed_heads(wq: torch.Tensor, w_ukv: torch.Tensor, h: torch.Tensor, cfg: ModelConfig,
                        ckv_buf: torch.Tensor, krope_buf: torch.Tensor, tables, seen: torch.Tensor) -> torch.Tensor:
    """The absorbed attention of the heads ``wq`` and ``w_ukv`` hold over the
    latent buffers, the query's RoPE ``tables`` and the buffer slots it
    ``seen`` given: ``(B, 1, heads, v)`` before ``wo``."""
    m = cfg.mla
    nope = m.qk_nope_head_dim
    q = L.project(h, wq, 3)  # (B, 1, H, nope + rope)
    q_nope, q_rope = q[..., :nope], L.rotate(q[..., nope:], *tables)
    w_uk, w_uv = w_ukv[..., :nope], w_ukv[..., nope:]  # (lora, H, nope), (lora, H, v)
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, w_uk)
    ckv = ckv_buf.to(q_abs.dtype)
    s_nope = torch.einsum("bshr,btr->bhst", q_abs, ckv)
    s_rope = torch.einsum("bshk,btk->bhst", q_rope, krope_buf.to(q_rope.dtype))
    s = (s_nope + s_rope).to(torch.float32) * (nope + m.qk_rope_head_dim) ** -0.5
    s = torch.where(seen, s, torch.full((), -1e30, device=s.device))
    p = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhst,btr->bshr", p.to(ckv.dtype), ckv)
    return torch.einsum("bshr,rhk->bshk", o_lat, w_uv)


def _mixer(mp: PyTree, spec: LayerSpec, cfg: ModelConfig, h: torch.Tensor, *, cache, pos0: int, decode: bool,
           collect: bool):
    if spec.mixer in ("attn", "attn_local"):
        local = spec.mixer == "attn_local"
        if decode:
            return _attn_decode(mp, h, cfg, local, cache, pos0)
        return L.apply_attention(mp, h, cfg, local=local, pos0=pos0, return_cache=collect)
    if spec.mixer == "mamba":
        return L.apply_mamba(mp, h, cfg, cache=cache)
    if spec.mixer == "mlstm":
        return L.apply_mlstm(mp, h, cfg, cache=cache)
    if spec.mixer == "slstm":
        return L.apply_slstm(mp, h, cfg, cache=cache)
    raise ValueError(spec.mixer)


def _apply_layer_shards(lps: list[PyTree], spec: LayerSpec, cfg: ModelConfig, xs: list[torch.Tensor], *,
                        caches: list, pos0: int, decode: bool, collect: bool):
    """Pre-norm mixer and FFN with residuals (and gemma's post-norms) on
    each batch shard of ``xs`` (one without a mesh), ``lps`` the shards'
    views of the layer; returns ``(xs, each shard's mixer cache or None,
    the MoE aux loss or None)``. The mixers and a dense FFN run shard by
    shard; an MoE FFN routes the shards together
    (:func:`~repro_torch.models.layers.apply_moe_ffn_shards`). Attention in
    decode mode writes its buffers in place; the recurrent mixers return
    their new state, which the caller stores."""
    outs, new_caches = [], []
    for lp, x, cache in zip(lps, xs, caches):
        mix, new_cache = _mixer(lp["mixer"], spec, cfg, L.rms_norm(lp["norm1"], x, cfg.norm_eps), cache=cache,
                                pos0=pos0, decode=decode, collect=collect)
        if cfg.use_post_norm:
            mix = L.rms_norm(lp["post_norm1"], mix, cfg.norm_eps)
        outs.append(x + mix)
        new_caches.append(new_cache)
    xs = outs
    aux = None
    if spec.ffn != "none":
        h2s = [L.rms_norm(lp["norm2"], x, cfg.norm_eps) for lp, x in zip(lps, xs)]
        if spec.ffn == "dense":
            fs = [L.apply_dense_ffn(lp["ffn"], h2) for lp, h2 in zip(lps, h2s)]
        else:
            fs, aux = L.apply_moe_ffn_shards([lp["ffn"] for lp in lps], h2s, cfg)
        if cfg.use_post_norm:
            fs = [L.rms_norm(lp["post_norm2"], f, cfg.norm_eps) for lp, f in zip(lps, fs)]
        xs = [x + f for x, f in zip(xs, fs)]
    return xs, new_caches, aux


def _apply_layer(lp: PyTree, spec: LayerSpec, cfg: ModelConfig, x: torch.Tensor, *, cache, pos0: int, decode: bool,
                 collect: bool):
    """:func:`_apply_layer_shards` on one batch: ``(x, the mixer's cache or
    None, the MoE aux loss or None)``."""
    xs, caches, aux = _apply_layer_shards([lp], spec, cfg, [x], caches=[cache], pos0=pos0, decode=decode,
                                          collect=collect)
    return xs[0], caches[0], aux


def _store(buffers: PyTree, new: PyTree) -> None:
    """Write a decode step's layer state into its cache buffers (views of
    the stacked cache) in place; attention's are those buffers already."""
    for k, t in new.items():
        if t is not buffers[k]:
            buffers[k].copy_(t)


def _sinusoidal(seq: int, d: int, dtype) -> torch.Tensor:
    """The encoder's fixed positions ``(seq, d)``: sin on the even
    channels, cos on the odd, ``pos / 10000 ** (2i / d)``, fp32 then
    cast."""
    pos = torch.arange(seq, dtype=torch.float32)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0), dim / d)
    pe = torch.zeros((seq, d), dtype=torch.float32)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle[:, : d // 2])
    return pe.to(dtype)


def _embed(cfg: ModelConfig, params: PyTree, batch: dict) -> torch.Tensor:
    """The input activations of one batch (shard): token embeddings (split
    over the vocabulary under a model mesh, per client with client-batched
    weights) or the fed embeddings, gemma's scale, an encoder's positions."""
    embed = params["embed"]
    device = (embed[0] if isinstance(embed, Ranks) else embed).device
    if "tokens" in batch:
        tokens = torch.as_tensor(batch["tokens"], device=device).long()
        if isinstance(embed, Ranks):
            x = _embed_ranks(embed, tokens)
        elif embed.dim() == 3:  # per-client embedding (C, V, d)
            rows = torch.arange(embed.shape[0], device=tokens.device).reshape(-1, *([1] * (tokens.dim() - 1)))
            x = embed[rows, tokens]
        else:
            x = embed[tokens]
    else:
        x = torch.as_tensor(batch["embeds"], device=device)
    if cfg.query_pre_attn_scalar is not None:  # gemma scales embeddings, in the input's dtype
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    if cfg.is_encoder:
        x = x + _sinusoidal(x.shape[-2], cfg.d_model, x.dtype).to(x.device)[None]
    return x


def forward(cfg: ModelConfig, params: PyTree, batch: dict, cache: PyTree | None = None,
            return_cache: bool = False, last: int | None = None):
    """Returns ``(logits, moe_aux_loss, new_cache)``, as the reference.

    ``batch``: ``{"tokens": int (B, S)}`` (or ``(C, n, S)`` with
    client-batched weights) or ``{"embeds": (B, S, d)}``. Decode mode iff
    ``cache`` is given: then ``S == 1``, the new token goes to buffer slot
    ``cache["len"]``, the buffers are updated in place and come back in
    ``new_cache`` with ``len + 1``. ``return_cache=True`` in full-sequence
    mode collects the prefill caches (attention's exact-length, ``(P, B,
    S, ...)`` in ``blocks``, ``(B, S, ...)`` in ``prefix``; the recurrent
    mixers' final states). ``last=n`` projects only the last ``n``
    positions to logits: the same numbers as the full projection's last
    ``n`` rows, without the ``(B, S, V)`` tensor (prefill keeps one). The
    MoE aux loss is the sum over the MoE layers, prefix first, then
    period by period.

    Remat: with ``cfg.train.remat``, while autograd records and outside
    decode and cache collection (where the reference wraps its period in
    ``jax.checkpoint``), each period runs under
    ``torch.utils.checkpoint``: only its input is kept, and the backward
    runs the period's forward again, the same kernels on the same shapes,
    so the result and the gradients keep every bit. The prefix layers are
    not wrapped, as in the reference."""
    logits, aux, caches = forward_shards(cfg, [params], [batch], None if cache is None else [cache],
                                         return_cache=return_cache, last=last)
    return logits[0], aux, caches[0]


def forward_shards(cfg: ModelConfig, params: list[PyTree], batches: list[dict], caches: list | None = None,
                   return_cache: bool = False, last: int | None = None):
    """:func:`forward` over the batch shards of one step in lockstep, layer
    by layer: ``params[b]`` is shard b's view (``launch.sharded.view``),
    ``batches[b]`` its rows, ``caches[b]`` its decode buffers. Returns each
    shard's logits, the one MoE aux loss (an MoE layer routes the shards'
    tokens as one batch, as the reference groups them) and each shard's
    new cache. With one shard and whole weights it is :func:`forward`."""
    decode = caches is not None
    collect = decode or return_cache
    pos0 = int(caches[0]["len"]) if decode else 0
    xs = [_embed(cfg, p, b) for p, b in zip(params, batches)]
    S = xs[0].shape[-2]
    aux = torch.zeros((), dtype=torch.float32, device=xs[0].device)
    new_caches = [{"len": pos0 + S} if collect else None for _ in xs]
    shards = range(len(xs))

    def run(xs, aux, layer_params, specs, layer_caches):
        """The layers in order from ``xs``: ``(xs, aux, each layer's caches
        over the shards)``."""
        ncs = []
        for i, spec in enumerate(specs):
            xs, nc, a = _apply_layer_shards([lp[i] for lp in layer_params], spec, cfg, xs,
                                            caches=[lc[i] for lc in layer_caches], pos0=pos0, decode=decode,
                                            collect=collect)
            if a is not None:
                aux = aux + a
            if decode:
                for lc, c in zip(layer_caches, nc):
                    _store(lc[i], c)
            ncs.append(nc)
        return xs, aux, ncs

    if cfg.prefix:
        pre = [caches[b]["prefix"] if decode else [None] * len(cfg.prefix) for b in shards]
        xs, aux, ncs = run(xs, aux, [p["prefix"] for p in params], cfg.prefix, pre)
        if collect and not decode:
            for b in shards:
                new_caches[b]["prefix"] = [nc[b] for nc in ncs]
    if cfg.num_periods:
        slots = [f"slot{i}" for i in range(len(cfg.pattern))]
        remat = cfg.train.remat and not collect and torch.is_grad_enabled()
        collected = []
        for p in range(cfg.num_periods):
            # the period's slices are taken outside the checkpoint, so its gradients reach the stacked leaves
            # through the same ops with remat on or off
            lps = [[tree_map(lambda t: t[p], v["blocks"][slot]) for slot in slots] for v in params]
            lcs = ([[tree_map(lambda t: t[p], caches[b]["blocks"][slot]) for slot in slots] for b in shards]
                   if decode else [[None] * len(slots) for _ in shards])
            if remat:
                xs, aux, ncs = checkpoint(run, xs, aux, lps, cfg.pattern, lcs, use_reentrant=False)
            else:
                xs, aux, ncs = run(xs, aux, lps, cfg.pattern, lcs)
            collected.append(ncs)
        if collect and not decode:
            for b in shards:
                new_caches[b]["blocks"] = {slot: {k: torch.stack([ncs[i][b][k] for ncs in collected])
                                                  for k in collected[0][i][b]} for i, slot in enumerate(slots)}
    logits = []
    for b, (v, x) in enumerate(zip(params, xs)):
        if decode:  # written in place
            new_caches[b].update({k: caches[b][k] for k in ("prefix", "blocks") if k in caches[b]})
        if last is not None:
            x = x[..., -last:, :]
        x = L.rms_norm(v["final_norm"], x, cfg.norm_eps)
        out = _head(x, v["embed"] if cfg.tie_embeddings else v["lm_head"], cfg.tie_embeddings)
        if cfg.final_logit_softcap is not None:
            cap = cfg.final_logit_softcap
            out = cap * torch.tanh(out / cap)
        logits.append(out)
    return logits, aux, new_caches
