"""Model configuration (counterpart of ``repro.configs.base``).

A model is ``prefix`` (unrolled layers) followed by ``pattern`` repeated
``num_periods`` times. Each layer is a (mixer, ffn) pair:

  mixer: "attn" | "attn_local" | "mamba" | "mlstm" | "slstm"
  ffn:   "dense" | "moe" | "none"

Attention is multi-head latent attention where the config has an
:class:`MLASpec`. :meth:`ModelConfig.param_count` and
:meth:`ModelConfig.active_param_count` are the reference's analytic counts;
:func:`reduced_config` cuts a config to the width its CPU tests run at;
``SHAPES`` names the workload shapes (``train_4k`` is the training
driver's).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

Mixer = Literal["attn", "attn_local", "mamba", "mlstm", "slstm"]
Ffn = Literal["dense", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: Mixer = "attn"
    ffn: Ffn = "dense"


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_expert: int
    num_shared: int = 0
    router_noise: float = 0.0


@dataclasses.dataclass(frozen=True)
class MLASpec:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    q_lora_rank: int | None = None


@dataclasses.dataclass(frozen=True)
class MambaSpec:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    optimizer: Literal["adamw", "adafactor", "sgdm"] = "adamw"
    microbatches: int = 1
    remat: bool = True
    dp_shard_params: bool = False
    learning_rate: float = 3e-4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: tuple[LayerSpec, ...]
    num_periods: int
    prefix: tuple[LayerSpec, ...] = ()
    head_dim: int | None = None
    moe: MoESpec | None = None
    mla: MLASpec | None = None
    mamba: MambaSpec | None = None
    causal: bool = True
    is_encoder: bool = False
    sliding_window: int = 4096
    rope_theta: float = 10000.0
    final_logit_softcap: float | None = None
    attn_logit_softcap: float | None = None
    query_pre_attn_scalar: float | None = None
    use_post_norm: bool = False
    tie_embeddings: bool = False
    embeds_input: bool = False
    moe_dropless: bool = False
    norm_eps: float = 1e-6
    train: TrainSpec = TrainSpec()
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    notes: str = ""

    @property
    def num_layers(self) -> int:
        return len(self.prefix) + len(self.pattern) * self.num_periods

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (the reference's layout)."""
        return math.ceil(self.vocab_size / 256) * 256

    @property
    def all_layers(self) -> tuple[LayerSpec, ...]:
        return self.prefix + self.pattern * self.num_periods

    def param_count(self) -> int:
        """The reference's analytic parameter count: embedding, untied head,
        every layer's mixer, FFN and two norms, the final norm. Its Mamba
        term counts the dt projection as ``di`` per input column (not the
        low-rank ``w_x``/``w_dt`` pair the layer holds), as the reference's
        does."""
        d, hd = self.d_model, self.resolved_head_dim
        n = self.padded_vocab * d
        if not self.tie_embeddings:
            n += d * self.padded_vocab
        for layer in self.all_layers:
            n += self._mixer_params(layer.mixer, d, hd)
            n += self._ffn_params(layer.ffn, d)
            n += 2 * d
        n += d
        return n

    def active_param_count(self) -> int:
        """Parameters a token passes through: an MoE layer counts its top-k
        and shared experts and its router only."""
        d, hd = self.d_model, self.resolved_head_dim
        n = self.padded_vocab * d
        if not self.tie_embeddings:
            n += d * self.padded_vocab
        for layer in self.all_layers:
            n += self._mixer_params(layer.mixer, d, hd)
            if layer.ffn == "moe":
                active = self.moe.top_k + self.moe.num_shared
                n += active * 3 * d * self.moe.d_expert + d * self.moe.num_experts
            else:
                n += self._ffn_params(layer.ffn, d)
            n += 2 * d
        n += d
        return n

    def _mixer_params(self, mixer: str, d: int, hd: int) -> int:
        if mixer in ("attn", "attn_local"):
            if self.mla is not None:
                m = self.mla
                n = d * self.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                n += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                n += m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
                n += self.num_heads * m.v_head_dim * d
                return n
            return d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d
        if mixer == "mamba":
            di, ds, dc = self.mamba.d_inner(d), self.mamba.d_state, self.mamba.d_conv
            return d * 2 * di + di * dc + di * (ds * 2 + 1) + di + di * ds + di + di * d
        if mixer == "mlstm":
            di = int(d * self.mlstm_proj_factor)
            return d * 2 * di + 3 * di * di // max(self.num_heads, 1) + 3 * di + di * d
        if mixer == "slstm":
            return 8 * d * d + 4 * d + int(d * self.slstm_proj_factor) * d * 2
        raise ValueError(mixer)

    def _ffn_params(self, ffn: str, d: int) -> int:
        if ffn == "dense":
            return 3 * d * self.d_ff
        if ffn == "moe":
            return (self.moe.num_experts + self.moe.num_shared) * 3 * d * self.moe.d_expert + d * self.moe.num_experts
        if ffn == "none":
            return 0
        raise ValueError(ffn)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """A named workload shape: sequence length, global batch and the step
    kind that runs it (the reference's)."""
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


ARCH_REGISTRY: dict[str, ModelConfig] = {}


def register_arch(config: ModelConfig) -> ModelConfig:
    ARCH_REGISTRY[config.name] = config
    return config


def get_config(name: str) -> ModelConfig:
    if name not in ARCH_REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCH_REGISTRY)}")
    return ARCH_REGISTRY[name]


def supports_shape(config: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(supported, the reason if not): the reference's skip rules."""
    if config.is_encoder and shape.kind == "decode":
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not config.subquadratic:
        return False, "pure full-attention arch; 500k decode needs sub-quadratic state"
    return True, ""


def reduced_config(config: ModelConfig, d_model: int = 64, periods: int = 2) -> ModelConfig:
    """A small config of the same family for CPU tests (the reference's
    cut): at most 4 heads, head width ``d_model // heads`` (at least 8),
    ``d_ff`` scaled with ``d_model``, a vocab of at most 512, ``periods``
    periods, one prefix layer at most and a sliding window of 16."""
    scale = d_model / config.d_model
    heads = max(2, min(config.num_heads, 4))
    kv = max(1, min(config.num_kv_heads, heads))
    kw: dict = dict(
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=max(8, d_model // heads),
        d_ff=max(16, int(config.d_ff * scale)) if config.d_ff else 0,
        vocab_size=min(config.vocab_size, 512),
        num_periods=periods,
        prefix=config.prefix[: min(len(config.prefix), 1)],
        train=dataclasses.replace(config.train, microbatches=1, dp_shard_params=False),
    )
    if config.moe is not None:
        kw["moe"] = dataclasses.replace(
            config.moe, num_experts=4, top_k=min(config.moe.top_k, 2),
            d_expert=max(16, int(config.moe.d_expert * scale)),
        )
    if config.mla is not None:
        kw["mla"] = MLASpec(kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8)
        kw["head_dim"] = 8
    if config.mamba is not None:
        kw["mamba"] = dataclasses.replace(config.mamba, d_state=8)
    if config.sliding_window:
        kw["sliding_window"] = 16
    return dataclasses.replace(config, **kw)
