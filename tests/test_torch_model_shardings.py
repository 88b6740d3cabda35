"""The model meshes' placement rules and input specs against the
reference's (``repro.launch.shardings``, ``repro.launch.specs``).

* ``param_shardings`` on the params and on the optimizer state,
  ``batch_shardings`` and ``cache_shardings`` give the reference's
  ``PartitionSpec``s leaf by leaf for all eleven archs, at full width, at
  reduced width and reduced with ZeRO (``dp_shard_params``), on the smoke,
  pod and multipod meshes. The reference's rules run on an
  ``AbstractMesh`` (they read only the axis names and extents).
* ``specs.py``'s state, cache and input specs (meta tensors) have the
  shapes and dtypes of the reference's ``eval_shape``s, and both parameter
  counts are the reference's, for all eleven full configs.
"""
import dataclasses
import functools
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import ARCH_REGISTRY as JAX_ARCHS
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.base import reduced_config as jax_reduced
from repro.launch import shardings as jax_shardings
from repro.launch import specs as jax_specs
from repro_torch.common.pytrees import tree_flatten_with_names, tree_leaves
from repro_torch.configs import ARCH_REGISTRY
from repro_torch.configs.base import SHAPES, reduced_config
from repro_torch.launch import shardings, specs
from repro_torch.launch.mesh import ModelMesh, make_production_mesh, make_smoke_mesh
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

ARCHS = sorted(ARCH_REGISTRY)
MESHES = {"smoke": ((1, 1), ("data", "model")), "pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
VARIANTS = ("full", "reduced", "reduced_zero")


def port_mesh(name: str) -> ModelMesh:
    shape, axes = MESHES[name]
    return ModelMesh(axes, shape, (torch.device("cpu"),) * math.prod(shape))


def jax_mesh(name: str) -> AbstractMesh:
    return AbstractMesh(*MESHES[name])


def _variant(cfg, variant: str, reduce):
    if variant == "full":
        return cfg
    cfg = reduce(cfg)
    if variant == "reduced_zero":
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, dp_shard_params=True))
    return cfg


@functools.lru_cache(maxsize=None)
def configs(arch: str, variant: str):
    return _variant(ARCH_REGISTRY[arch], variant, reduced_config), _variant(JAX_ARCHS[arch], variant, jax_reduced)


@functools.lru_cache(maxsize=None)
def state_shapes(arch: str, variant: str):
    cfg, jcfg = configs(arch, variant)
    return specs.state_specs(cfg), jax_specs.state_specs(jcfg)


def ref_specs(tree) -> list[tuple]:
    return [tuple(s.spec) for s in jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, NamedSharding))]


def test_production_meshes_have_the_references_axes():
    cpu = torch.device("cpu")
    pod = make_production_mesh(devices=[cpu] * 256)
    multi = make_production_mesh(multi_pod=True, devices=[cpu] * 512)
    assert pod.shape == {"data": 16, "model": 16} and pod.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and multi.size == 512
    assert make_smoke_mesh([cpu]).shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="needs 256 devices, 8 given"):
        make_production_mesh(devices=[cpu] * 8)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_state_shardings_equal_the_references(arch, variant, mesh):
    cfg, jcfg = configs(arch, variant)
    port, ref = state_shapes(arch, variant)
    pm, jm = port_mesh(mesh), jax_mesh(mesh)
    got = shardings.param_shardings_flat(cfg, pm, port.params)
    assert got == ref_specs(jax_shardings.param_shardings(jcfg, jm, ref.params))
    names = [n for n, _ in tree_flatten_with_names(port.params)]
    assert shardings.param_shardings(cfg, pm, port.params)["embed"] == got[names.index(("embed",))]
    got_opt = shardings.param_shardings_flat(cfg, pm, port.opt_state)
    assert got_opt == ref_specs(jax_shardings.param_shardings(jcfg, jm, ref.opt_state))
    if mesh != "smoke" and variant != "full":  # something splits
        assert any("model" in s for s in got)
    if variant == "reduced_zero" and mesh != "smoke":
        assert any("data" in s for s in got)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_shardings_equal_the_references(arch, mesh):
    cfg, jcfg = configs(arch, "full")
    pm, jm = port_mesh(mesh), jax_mesh(mesh)
    for name in ("train_4k", "decode_32k", "long_500k"):
        shape, jshape = SHAPES[name], JAX_SHAPES[name]
        batch = specs.train_batch_specs(cfg, shape)
        jbatch = jax_specs.train_batch_specs(jcfg, jshape)
        got = shardings.batch_shardings(cfg, shape, pm, batch)
        assert [got[k] for k in sorted(got)] == ref_specs(jax_shardings.batch_shardings(jcfg, jshape, jm, jbatch))
        if cfg.is_encoder:
            continue
        cache, jcache = specs.cache_specs(cfg, shape), jax_specs.cache_specs(jcfg, jshape)
        got = shardings.cache_shardings_flat(cfg, pm, cache, shape.global_batch)
        assert got == ref_specs(jax_shardings.cache_shardings(jcfg, jm, jcache, jshape.global_batch))
    assert shardings.replicated(pm) == tuple(jax_shardings.replicated(jm).spec)


def _shapes_and_dtypes(tree, jtree) -> tuple[list, list]:
    port = [(tuple(t.shape), str(t.dtype).replace("torch.", "")) for t in tree_leaves(tree)]
    ref = [(tuple(t.shape), str(t.dtype)) for t in jax.tree_util.tree_leaves(jtree)]
    return port, ref


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_references_eval_shapes(arch):
    cfg, jcfg = configs(arch, "full")
    port, ref = state_shapes(arch, "full")
    assert all(t.device.type == "meta" for t in tree_leaves(port))
    got, want = _shapes_and_dtypes(port, ref)
    assert got == want
    for name, shape in SHAPES.items():
        jshape = JAX_SHAPES[name]
        if cfg.is_encoder and shape.kind == "decode":
            continue
        got, want = _shapes_and_dtypes(specs.input_specs(cfg, shape, torch.float32),
                                       jax_specs.input_specs(jcfg, jshape, np.float32))
        assert got == want, name
    assert specs.model_param_count(cfg) == jax_specs.model_param_count(jcfg)
    assert specs.model_active_param_count(cfg) == jax_specs.model_active_param_count(jcfg)
    for n in (1, 16, 256):
        assert specs.effective_microbatches(cfg, SHAPES["train_4k"], n) == \
            jax_specs.effective_microbatches(jcfg, JAX_SHAPES["train_4k"], n)
