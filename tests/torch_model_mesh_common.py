"""What the model-mesh parity tests share: the meshes, the port's sharded
and unmeshed runs, and the reference's sharded steps in a child
interpreter.

The port runs on meshes that repeat the ``cpu`` device: (2, 4) and (4, 2)
``("data", "model")`` and (2, 2, 2) ``("pod", "data", "model")``. The
reference runs the same meshes in one child interpreter on a forced
8-device host with ``Auto`` axes (its drivers' default explicit axes raise
``ShardingTypeError`` on jax 0.9), its params placed by
``param_shardings``, its batch by ``batch_shardings``, its decode buffers
by ``cache_shardings``, and the port's weights handed over as numpy. A run
is the forward's and the prefill's logits, ``GEN`` greedy tokens and one
train step (its loss and every parameter after it); with ``grads`` also
the loss's gradient at the initial params over the whole batch, each side
through its own sharded backward.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import torch

from repro_torch.common.pytrees import tree_flatten_with_names, tree_leaves
from repro_torch.configs import ARCH_REGISTRY
from repro_torch.configs.base import reduced_config
from repro_torch.interop import tree_to_numpy
from repro_torch.launch import sharded
from repro_torch.launch import serve as port_serve
from repro_torch.launch.mesh import ModelMesh
from repro_torch.launch.shardings import param_shardings_flat
from repro_torch.models import dist
from repro_torch.models.model import forward, init_params
from repro_torch.models.steps import TrainState, _grads, _sharded_forward, _sharded_grads, make_optimizer, make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
MESHES = {"2x4": ((2, 4), ("data", "model")), "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model"))}
B, S, GEN = 4, 16, 3


def case_config(registry, reduce, arch: str):
    """The case's config from ``registry`` (the port's or the reference's):
    reduced but tiny_lm, command-r-35b with ZeRO."""
    cfg = registry[arch]
    if arch != "tiny_lm":
        cfg = reduce(cfg)
    if arch == "command-r-35b":
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, dp_shard_params=True))
    return cfg


def config(arch: str):
    return case_config(ARCH_REGISTRY, reduced_config, arch)


def port_mesh(name: str) -> ModelMesh:
    shape, axes = MESHES[name]
    return ModelMesh(axes, shape, (CPU,) * int(np.prod(shape)))


def inputs(cfg) -> dict:
    rng = np.random.default_rng(1)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


def weights(cfg):
    return init_params(cfg, torch.Generator().manual_seed(0))


def place(cfg, params, mesh):
    return sharded.shard_tree(params, param_shardings_flat(cfg, mesh, params), mesh)


def port_run(arch: str, mesh_name: str | None, grads: bool = False) -> dict:
    """Forward logits, prefill logits, GEN greedy tokens and one train step
    (loss, params) of the port, on ``mesh_name`` or unmeshed; with ``grads``
    the first step's gradients too (``steps._grads`` or ``_sharded_grads``
    on the whole batch, gathered)."""
    cfg = config(arch)
    data = inputs(cfg)
    params = weights(cfg)
    mesh = port_mesh(mesh_name) if mesh_name else None
    placed = params if mesh is None else place(cfg, params, mesh)
    tokens = torch.from_numpy(data["tokens"]).long()
    out = {}
    with dist.use_mesh(mesh):
        with torch.no_grad():
            if mesh is None:
                out["forward"] = forward(cfg, placed, {"tokens": tokens})[0]
            else:
                out["forward"] = _sharded_forward(cfg, placed, {"tokens": tokens}, mesh)[0]
        logits, cache = port_serve.prefill(cfg, placed, tokens, GEN)
        out["prefill"] = logits[:, -1]
        out["tokens"] = port_serve.decode(cfg, placed, cache, logits, GEN)[0].numpy()
        opt = make_optimizer(cfg)
        state = TrainState(params, opt.init(params), torch.zeros((), dtype=torch.int32))
        if mesh is not None:
            state = sharded.shard_state(cfg, state, mesh)
        if grads:
            batch = {k: torch.from_numpy(v) for k, v in data.items()}
            g = (_grads(cfg, params, batch) if mesh is None else _sharded_grads(cfg, state.params, batch, mesh))[1]
            out["grads"] = tree_to_numpy(g if mesh is None else sharded.gather_tree(g))
        state, metrics = make_train_step(cfg, opt)(state, data)
    out["loss"] = float(metrics["loss"])
    out["params"] = tree_to_numpy(sharded.gather_state(state).params)
    out["forward"], out["prefill"] = out["forward"].numpy(), out["prefill"].numpy()
    return out


# ------------------------------------------------------------ the reference
_REFERENCE = textwrap.dedent(
    """
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import AxisType
    from repro.configs import ARCH_REGISTRY
    from repro.configs.base import reduced_config
    from repro.launch.shardings import batch_shardings, cache_shardings, param_shardings, replicated
    from repro.models import dist
    from repro.models.model import forward, init_cache
    from repro.models.steps import TrainState, _loss_fn, make_optimizer, make_prefill_step, make_serve_step, make_train_step

    sys.path.insert(0, "tests")
    from torch_model_mesh_common import GEN, MESHES, case_config

    assert len(jax.devices()) == 8
    with open(sys.argv[1], "rb") as f:
        cases = pickle.load(f)
    results = {}
    with_grads = sys.argv[3] == "1"
    for (arch, mesh_name), (params_np, data) in cases.items():
        cfg = case_config(ARCH_REGISTRY, reduced_config, arch)
        shape, axes = MESHES[mesh_name]
        mesh = jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))
        dist.set_mesh(mesh)
        params = jax.tree_util.tree_map(jnp.asarray, params_np)
        p_sh = param_shardings(cfg, mesh, params)
        params = jax.device_put(params, p_sh)
        b_sh = batch_shardings(cfg, None, mesh, data)
        batch = jax.device_put({k: jnp.asarray(v) for k, v in data.items()}, b_sh)
        out = {}
        with mesh:
            out["forward"] = np.asarray(jax.jit(lambda p, b: forward(cfg, p, b)[0])(params, {"tokens": batch["tokens"]}))
            logits, pre = jax.jit(make_prefill_step(cfg))(params, {"tokens": batch["tokens"]})
            out["prefill"] = np.asarray(logits[:, -1])
            B, L = data["tokens"].shape
            cache = init_cache(cfg, B, ctx_len=L, margin=GEN + 8)

            def graft(fixed, p):
                if fixed.shape == p.shape:
                    return p
                axis = next(i for i, (a, b) in enumerate(zip(fixed.shape, p.shape)) if a != b)
                pad = [(0, 0)] * fixed.ndim
                pad[axis] = (0, fixed.shape[axis] - p.shape[axis])
                return jnp.pad(p, pad)

            cache = jax.tree_util.tree_map(graft, cache, pre)
            cache = jax.device_put(cache, cache_shardings(cfg, mesh, cache, B))
            serve = jax.jit(make_serve_step(cfg))
            tok = jnp.argmax(logits[:, -1, : cfg.vocab_size], axis=-1)[:, None]
            toks = []
            for _ in range(GEN):
                toks.append(np.asarray(tok))
                logits, cache = serve(params, cache, {"tokens": tok})
                tok = jnp.argmax(logits[:, -1, : cfg.vocab_size], axis=-1)[:, None]
            out["tokens"] = np.concatenate(toks, axis=1)
            opt = make_optimizer(cfg)
            if with_grads:
                grad = jax.jit(jax.grad(lambda p, b: _loss_fn(cfg, p, b)[0]))(params, batch)
                out["grads"] = jax.tree_util.tree_map(np.asarray, grad)
            state = TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
            state_sh = TrainState(p_sh, param_shardings(cfg, mesh, state.opt_state), replicated(mesh))
            state = jax.device_put(state, state_sh)
            step = jax.jit(make_train_step(cfg, opt), in_shardings=(state_sh, b_sh), out_shardings=(state_sh, None))
            state, metrics = step(state, batch)
            out["loss"] = float(metrics["loss"])
            out["params"] = jax.tree_util.tree_map(np.asarray, state.params)
        dist.set_mesh(None)
        results[(arch, mesh_name)] = out
    with open(sys.argv[2], "wb") as f:
        pickle.dump(results, f)
    """
)


def reference_runs(keys, directory, grads: bool = False) -> dict:
    """The reference's sharded run of each ``(arch, mesh name)`` in ``keys``,
    in one child interpreter, on the port's weights; with ``grads`` the
    first step's gradients too (``jax.grad`` of its ``_loss_fn``)."""
    cases = {}
    for arch, mesh_name in keys:
        cfg = config(arch)
        cases[(arch, mesh_name)] = (tree_to_numpy(weights(cfg)), inputs(cfg))
    with open(directory / "in.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in ("src", os.environ.get("PYTHONPATH", "")) if p),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, str(directory / "in.pkl"), str(directory / "out.pkl"),
                           "1" if grads else "0"],
                          capture_output=True, text=True, timeout=900, env=env, cwd=ROOT)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    with open(directory / "out.pkl", "rb") as f:
        return pickle.load(f)


def grad_gaps(got, want) -> dict:
    """Each leaf's max |difference| over its max |gradient| in ``want`` (the
    difference itself where ``want`` is 0 throughout), by leaf."""
    out = {}
    for i, ((name, a), b) in enumerate(zip(tree_flatten_with_names(got), tree_leaves(want))):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, name
        scale, diff = np.max(np.abs(b)), np.max(np.abs(a - b))
        out[f"{i}:" + "/".join(str(k) for k in name if k is not None)] = diff / scale if scale > 0 else diff
    return out
