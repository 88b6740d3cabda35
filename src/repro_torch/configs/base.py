"""Model configuration (counterpart of ``repro.configs.base``, the subset
the port's LM and serving paths need).

A model is ``prefix`` (unrolled layers) followed by ``pattern`` repeated
``num_periods`` times. Each layer is a (mixer, ffn) pair. The port's model
(:mod:`repro_torch.models.model`) runs the dense subset: ``attn`` /
``attn_local`` mixers with ``dense`` FFNs; the MoE, MLA and Mamba specs are
kept only so that every field of :class:`ModelConfig` can be constructed.
:func:`reduced_config` cuts a config to the width its CPU tests run at.
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


ARCH_REGISTRY: dict[str, ModelConfig] = {}


def register_arch(config: ModelConfig) -> ModelConfig:
    ARCH_REGISTRY[config.name] = config
    return config


def get_config(name: str) -> ModelConfig:
    if name not in ARCH_REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCH_REGISTRY)}")
    return ARCH_REGISTRY[name]


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
