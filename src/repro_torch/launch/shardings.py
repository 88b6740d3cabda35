"""Placement rules: the parameter, optimizer-state, batch and cache layout
of every architecture on a model mesh (counterpart of
``repro.launch.shardings``).

A spec is a plain tuple with one entry a dim: a mesh axis name, a tuple of
axis names (the multipod batch's ``("pod", "data")``), or None (replicated); it
holds what the reference's ``PartitionSpec`` holds, so it may be shorter
than the leaf's rank (the missing dims are replicated). The functions
return trees of specs of the input tree's structure; the ``*_flat``
variants the specs in tree order.

Policy, as the reference's:
  * batch dims -> ``("pod", "data")`` where the batch divides;
  * heads, FFN width, ``d_inner`` dims -> ``model`` (tensor parallelism);
  * vocabulary -> ``model``;
  * MoE experts -> ``model`` over the expert width (``_MOE_RULES``; the
    expert-parallel ``_MOE_EP_RULES`` are kept beside them);
  * ZeRO (``cfg.train.dp_shard_params``): also the first dim the rule
    marks ``data`` that the data axis divides.

A leaf's rule is chosen by the last name on its path that has one, fitted
to its shape: an axis is kept only where it divides the dim, each axis at
most once, and a stacked-period leaf (under ``blocks``) shifts its rule
right by one dim. Optimizer slots reuse their parameter's rule, truncated
to their rank.
"""
from __future__ import annotations

from typing import Any

from repro_torch.common.pytrees import tree_flatten_with_names, tree_unflatten
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import axis_size, batch_axes

PyTree = Any
Spec = tuple

# each dim's wanted mesh axis ("model"/"data") or None, fitted to divisibility
_RULES: dict[str, tuple] = {
    # embedding / head
    "embed": ("model", "data"),           # (V, D)
    "lm_head": ("data", "model"),         # (D, V)
    # attention
    "wq": ("data", "model", None),        # (D, H, hd)
    "wk": ("data", "model", None),
    "wv": ("data", "model", None),
    "wo": ("model", None, "data"),        # (H, hd, D)
    # MLA
    "w_dkv": ("data", "model"),           # (D, lora+rope)
    "w_ukv": ("data", "model", None),     # (lora, H, nope+v)
    # dense ffn
    "wg": ("data", "model"),              # (D, F)  [or (E, D, De) for MoE]
    "wu": ("data", "model"),
    "wd": ("model", "data"),              # (F, D)  [or (E, De, D)]
    "router": (None, None),
    # mamba
    "w_in": ("data", "model"),            # (D, 2Di)
    "conv_w": (None, "model"),            # (dc, Di)
    "conv_b": ("model",),
    "w_x": ("model", None),               # (Di, dt_rank + 2 ds)
    "w_dt": (None, "model"),              # (dt_rank, Di)
    "dt_bias": ("model",),
    "A_log": ("model", None),             # (Di, ds)
    "D": ("model",),
    "w_out": ("model", "data"),           # (Di, D)
    # xLSTM
    "w_up": ("data", "model"),            # (D, 2Di)
    "w_i": ("model", None),
    "w_f": ("model", None),
    "f_bias": (None,),
    "w_down": ("model", "data"),          # (Di, D)
    "wgx": ("data", None, "model"),       # (D, 4, D) gate-aligned channel TP
    "wgh": ("data", None, "model"),
    "gbias": (None, "model"),
    "bias": ("model",),
    "ffn_up": ("data", "model"),
    "ffn_down": ("model", "data"),
    "b_out": (None,),
    "w_out_rnn": (None, None),
}

_MOE_RULES = {
    "wg": (None, "data", "model"),        # (E, D, De): TP over De
    "wu": (None, "data", "model"),
    "wd": (None, "model", "data"),        # (E, De, D)
}

_MOE_EP_RULES = {
    "wg": ("model", "data", None),        # (E, D, De): expert-parallel over E
    "wu": ("model", "data", None),
    "wd": ("model", None, "data"),
}


def _fit(rule: tuple, shape: tuple, mesh, zero: bool) -> Spec:
    """Fit a rule to a shape: an axis only where the dim divides, ``data``
    only with ZeRO, each axis once; the rule truncated or padded to the
    rank."""
    specs = []
    used: set[str] = set()
    rule = rule[: len(shape)] + (None,) * max(0, len(shape) - len(rule))
    for dim, want in zip(shape, rule):
        axis = None
        if (want == "model" and "model" in mesh.axis_names and dim % axis_size(mesh, "model") == 0
                and "model" not in used):
            axis = "model"
        elif want == "data" and zero and dim % axis_size(mesh, "data") == 0 and "data" not in used:
            axis = "data"
        specs.append(axis)
        if axis:
            used.add(axis)
    return tuple(specs)


def _param_spec(cfg: ModelConfig, mesh, names: tuple, shape: tuple, zero: bool) -> Spec:
    name = next((k for k in reversed(names) if isinstance(k, str) and k in _RULES), "")
    moe = "ffn" in names and name in _MOE_RULES and len(shape) == 3 and cfg.moe is not None
    if "shared" in names:  # the shared experts under MoE take the dense 2-D rules
        moe = False
    if name == "w_h" and "wh0" in str(names):
        name = ""
    if moe:
        rule = _MOE_RULES[name]
    elif name:
        rule = _RULES[name]
    else:
        rule = (None,) * len(shape)
    # stacked-period leaves are (num_periods, *logical shape): the rule shifts right by one dim
    if "blocks" in names and len(shape) == len(rule) + 1:
        rule = (None,) + rule
    return _fit(rule, shape, mesh, zero)


def param_shardings_flat(cfg: ModelConfig, mesh, shapes: PyTree) -> list[Spec]:
    zero = cfg.train.dp_shard_params
    return [_param_spec(cfg, mesh, names, tuple(leaf.shape), zero)
            for names, leaf in tree_flatten_with_names(shapes)]


def param_shardings(cfg: ModelConfig, mesh, shapes: PyTree) -> PyTree:
    """Specs for a params-shaped tree (params, gradients, or an optimizer
    slot tree whose leaf names mirror the params')."""
    return tree_unflatten(shapes, param_shardings_flat(cfg, mesh, shapes))


def replicated(mesh) -> Spec:
    return ()


def _batch_entry(mesh):
    """The batch axes as a spec entry: one axis by its name (as
    ``PartitionSpec`` normalizes a one-axis tuple), else the tuple."""
    baxes = batch_axes(mesh)
    return baxes[0] if len(baxes) == 1 else baxes


def _dp(mesh) -> int:
    dp = 1
    for a in batch_axes(mesh):
        dp *= axis_size(mesh, a)
    return dp


def batch_shardings(cfg: ModelConfig, shape, mesh, batch_shapes: PyTree) -> PyTree:
    """The batch dim over ``("pod", "data")``; replicated where the batch
    does not divide (``long_500k``'s batch of 1). ``shape`` is unused, as in
    the reference."""
    baxes, dp = _batch_entry(mesh), _dp(mesh)

    def spec(leaf) -> Spec:
        shp = tuple(leaf.shape)
        if shp and shp[0] % dp == 0:
            return (baxes,) + (None,) * (len(shp) - 1)
        return ()

    return tree_unflatten(batch_shapes, [spec(leaf) for _, leaf in tree_flatten_with_names(batch_shapes)])


def _cache_spec(names: tuple, shp: tuple, mesh) -> Spec:
    baxes, dp, tp = _batch_entry(mesh), _dp(mesh), axis_size(mesh, "model")
    data = axis_size(mesh, "data")
    name = next((k for k in reversed(names) if isinstance(k, str)), "")
    if name == "len" or not shp:
        return ()
    batch_ok = shp[0] % dp == 0 and shp[0] >= dp
    b_spec = baxes if batch_ok else None
    if name in ("k", "v"):  # (B, S, KV, hd)
        seq_spec = None if batch_ok else ("data" if shp[1] % data == 0 else None)
        if shp[2] % tp == 0:
            return (b_spec, seq_spec, "model", None)
        if shp[3] % tp == 0:
            return (b_spec, seq_spec, None, "model")
        return (b_spec, seq_spec, None, None)
    if name in ("ckv", "krope"):  # (B, S, r)
        seq_spec = None if batch_ok else ("data" if shp[1] % data == 0 else None)
        return (b_spec, seq_spec, "model" if shp[2] % tp == 0 else None)
    if name == "conv":  # (B, dc-1, Di)
        return (b_spec, None, "model" if shp[2] % tp == 0 else None)
    if name == "ssm":  # (B, Di, ds)
        return (b_spec, "model" if shp[1] % tp == 0 else None, None)
    if name == "C":  # (B, h, hd, hd)
        return (b_spec, None, None, "model" if shp[3] % tp == 0 else None)
    if name in ("n", "m", "c", "h"):
        last_ok = shp[-1] % tp == 0
        return (b_spec, *(None,) * (len(shp) - 2), "model" if last_ok and len(shp) > 1 else None)
    return (b_spec, *(None,) * (len(shp) - 1))


def cache_shardings_flat(cfg: ModelConfig, mesh, cache_shapes: PyTree, global_batch: int) -> list[Spec]:
    return [_cache_spec(names, tuple(getattr(leaf, "shape", ())), mesh)
            for names, leaf in tree_flatten_with_names(cache_shapes)]


def cache_shardings(cfg: ModelConfig, mesh, cache_shapes: PyTree, global_batch: int) -> PyTree:
    """Decode-buffer specs: the batch over ``("pod", "data")`` where it
    divides, else an attention buffer's sequence dim over ``data``; head
    and feature dims over ``model`` where they divide. The rules read a
    leaf's leading dims as the unstacked buffer's (the reference's), so on
    a stacked ``blocks`` buffer ``(P, B, S, KV, hd)`` they test the period
    dim for the batch. ``len`` is replicated."""
    return tree_unflatten(cache_shapes, cache_shardings_flat(cfg, mesh, cache_shapes, global_batch))
