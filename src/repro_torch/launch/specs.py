"""Shape-and-dtype specs of every (arch x shape) cell's inputs
(counterpart of ``repro.launch.specs``): tensors on ``torch.device("meta")``,
so no memory is allocated even for the 405B-class models. The parameter and
state specs trace the port's own ``init_params`` and optimizer ``init``
under ``FakeTensorMode`` (every tensor a shape and a dtype) and come back
as meta tensors. The frontend-stub archs (pixtral, hubert) take ``embeds``
instead of tokens.
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.common.pytrees import tree_leaves, tree_map
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models.model import init_cache, init_params
from repro_torch.models.steps import TrainState, make_optimizer

PyTree = Any


def meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _as_meta(tree: PyTree) -> PyTree:
    return tree_map(lambda t: meta(t.shape, t.dtype), tree)


def effective_microbatches(cfg: ModelConfig, shape: ShapeSpec, dp: int) -> int:
    """The largest n up to the configured count with n | global_batch and
    dp | (global_batch / n): every microbatch still splits evenly over the
    data axes."""
    want = max(1, cfg.train.microbatches)
    n = 1
    for cand in range(1, want + 1):
        if shape.global_batch % cand == 0 and (shape.global_batch // cand) % max(dp, 1) == 0:
            n = cand
    return n


def train_batch_specs(cfg: ModelConfig, shape: ShapeSpec, dtype=torch.bfloat16) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if cfg.embeds_input:
        return {"embeds": meta((B, S, cfg.d_model), dtype), "labels": meta((B, S), torch.int32)}
    return {"tokens": meta((B, S), torch.int32), "labels": meta((B, S), torch.int32)}


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeSpec, dtype=torch.bfloat16) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if cfg.embeds_input:
        return {"embeds": meta((B, S, cfg.d_model), dtype)}
    return {"tokens": meta((B, S), torch.int32)}


def decode_batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    return {"tokens": meta((shape.global_batch, 1), torch.int32)}


def _fake_params(cfg: ModelConfig, dtype) -> PyTree:
    """The params as fake tensors, each floating leaf in ``dtype`` but the
    reference's fp32 ones (``models.model.init_params(dtype=)``)."""
    return init_params(cfg, torch.Generator(), dtype=dtype)


def param_specs(cfg: ModelConfig, dtype=torch.bfloat16) -> PyTree:
    with FakeTensorMode():
        params = _fake_params(cfg, dtype)
    return _as_meta(params)


def state_specs(cfg: ModelConfig, dtype=torch.bfloat16) -> TrainState:
    """The ``TrainState`` (params, the config's optimizer state, step)."""
    with FakeTensorMode():
        params = _fake_params(cfg, dtype)
        state = TrainState(params, make_optimizer(cfg).init(params), torch.zeros((), dtype=torch.int32))
    return _as_meta(state)


def cache_specs(cfg: ModelConfig, shape: ShapeSpec, dtype=torch.bfloat16) -> PyTree:
    """The decode buffers (``len`` an int32 scalar, as the reference's)."""
    with FakeTensorMode():
        cache = init_cache(cfg, shape.global_batch, ctx_len=shape.seq_len, dtype=dtype)
    cache["len"] = torch.zeros((), dtype=torch.int32)
    return _as_meta(cache)


def input_specs(cfg: ModelConfig, shape: ShapeSpec, dtype=torch.bfloat16) -> dict:
    """What a cell's step function takes."""
    if shape.kind == "train":
        return {"state": state_specs(cfg, dtype), "batch": train_batch_specs(cfg, shape, dtype)}
    if shape.kind == "prefill":
        return {"params": param_specs(cfg, dtype), "batch": prefill_batch_specs(cfg, shape, dtype)}
    if shape.kind == "decode":
        return {"params": param_specs(cfg, dtype), "cache": cache_specs(cfg, shape, dtype),
                "batch": decode_batch_specs(cfg, shape)}
    raise ValueError(shape.kind)


def model_param_count(cfg: ModelConfig) -> int:
    """The exact parameter count of the spec tree (no allocation)."""
    return sum(math.prod(leaf.shape) for leaf in tree_leaves(param_specs(cfg)))


def model_active_param_count(cfg: ModelConfig) -> int:
    """Parameters a token meets: the total less the routed experts it skips."""
    total = model_param_count(cfg)
    if cfg.moe is None:
        return total
    moe_layers = sum(1 for layer in cfg.all_layers if layer.ffn == "moe")
    per_expert = 3 * cfg.d_model * cfg.moe.d_expert
    return total - moe_layers * (cfg.moe.num_experts - cfg.moe.top_k) * per_expert
