"""The dense decoders on model meshes: the port's sharded forward, prefill,
decode and train step against the reference's sharded step functions.

The port runs on (2, 4) ``("data", "model")`` and (2, 2, 2) ``("pod",
"data", "model")`` meshes that repeat the ``cpu`` device. The reference
runs the same meshes in a child interpreter on a forced 8-device host with
``Auto`` axes (its drivers' default explicit axes raise
``ShardingTypeError`` on jax 0.9), its params placed by
``param_shardings``, its batch by ``batch_shardings``, its decode buffers
by ``cache_shardings``, and the port's weights handed over as numpy.
Cases: reduced llama3.2-1b, reduced gemma2-2b (softcap, window), tiny_lm
(KV 2 at tp 4: each rank slices its KV head) and reduced command-r-35b
with ZeRO (``dp_shard_params``).

* ``forward`` and prefill logits within 2e-5 (the reference's own
  sharded-against-unsharded gap is 3.7e-6); greedy decode tokens equal.
* One train step: the loss within 1e-6 relative, every parameter within
  5e-5 (the reference's own gap, 1.1e-5).
* The one-device smoke mesh is the unmeshed run bit for bit, serving and
  training.
* A sharded train run stopped at step 2 and resumed equals the
  uninterrupted run; its checkpoint restores into the unsharded port and
  into the reference's ``Checkpointer``.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.common.pytrees import tree_flatten_with_names, tree_leaves
from repro_torch.configs import ARCH_REGISTRY
from repro_torch.configs.base import reduced_config
from repro_torch.data.lm import token_stream
from repro_torch.kernels import ops
from repro_torch.launch import sharded
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.shardings import param_shardings_flat
from repro_torch.models import dist
from repro_torch.models.model import forward
from repro_torch.models.steps import TrainState, _sharded_forward, make_optimizer, make_prefill_step, make_train_step
from torch_model_mesh_common import (B, CPU, S, case_config, config, inputs, port_mesh, port_run, reference_runs,
                                     weights)
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

MESHES = ("2x4", "2x2x2")
CASES = ("llama3.2-1b", "gemma2-2b", "tiny_lm", "command-r-35b")
GEN = 3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case, the port's sharded run, its unmeshed run and the
    reference's sharded run (one child interpreter for all)."""
    keys = [(arch, mesh) for arch in CASES for mesh in MESHES]
    ref = reference_runs(keys, tmp_path_factory.mktemp("model_mesh"))
    return {"reference": ref, "port": {key: port_run(*key) for key in keys},
            "single": {arch: port_run(arch, None) for arch in CASES}}


CASE_IDS = [(a, m) for a in CASES for m in MESHES]


@pytest.mark.parametrize("arch,mesh", CASE_IDS)
def test_sharded_forward_and_prefill_match_the_reference(runs, arch, mesh):
    got, want = runs["port"][(arch, mesh)], runs["reference"][(arch, mesh)]
    np.testing.assert_allclose(got["forward"], want["forward"], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["prefill"], want["prefill"], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["forward"], runs["single"][arch]["forward"], rtol=0, atol=2e-5)


@pytest.mark.parametrize("arch,mesh", CASE_IDS)
def test_sharded_decode_tokens_equal_the_references(runs, arch, mesh):
    got, want = runs["port"][(arch, mesh)], runs["reference"][(arch, mesh)]
    assert got["tokens"].shape == (B, GEN)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(got["tokens"], runs["single"][arch]["tokens"])


@pytest.mark.parametrize("arch,mesh", CASE_IDS)
def test_sharded_train_step_matches_the_reference(runs, arch, mesh):
    got, want = runs["port"][(arch, mesh)], runs["reference"][(arch, mesh)]
    assert abs(got["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"])
    import jax

    for a, b in zip(tree_leaves(got["params"]), jax.tree_util.tree_leaves(want["params"])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=5e-5)


def test_kv_slice_and_splits_are_exercised():
    """The cases cover what the port lays out: tiny_lm's KV heads replicated
    on tp 4 (each rank slices one), split on tp 2; heads, FFN width and
    vocabulary split; ZeRO blocks over ``data``."""
    tiny, cmd = config("tiny_lm"), config("command-r-35b")
    for name, kv_split in (("2x4", False), ("2x2x2", True)):
        mesh = port_mesh(name)
        view = sharded.view(sharded.shard_tree(weights(tiny), param_shardings_flat(tiny, mesh, weights(tiny)), mesh), 0)
        mixer = view["blocks"]["slot0"]["mixer"]
        assert isinstance(mixer["wq"], dist.Ranks) and isinstance(mixer["wk"], dist.Ranks) == kv_split
        assert isinstance(view["embed"], dist.Ranks) and isinstance(view["blocks"]["slot0"]["ffn"]["wg"], dist.Ranks)
    specs = param_shardings_flat(cmd, port_mesh("2x4"), weights(cmd))
    assert any("data" in s for s in specs)


def test_one_device_smoke_mesh_is_the_unmeshed_run_bit_for_bit(tmp_path):
    cfg = config("llama3.2-1b")
    plain = port_serve.serve(cfg, batch=2, prompt=12, gen=4, device="cpu", keep_logits=True, verbose=False)
    smoke = port_serve.serve(cfg, batch=2, prompt=12, gen=4, device="cpu", keep_logits=True, verbose=False,
                             mesh=make_smoke_mesh([CPU]))
    np.testing.assert_array_equal(plain["tokens"], smoke["tokens"])
    for a, b in zip(plain["logits"], smoke["logits"]):
        assert torch.equal(a, b)
    a = port_train.train(cfg, steps=2, batch=2, seq=8, device="cpu", verbose=False)
    b = port_train.train(cfg, steps=2, batch=2, seq=8, device="cpu", verbose=False, mesh=make_smoke_mesh([CPU]))
    assert a["losses"] == b["losses"]
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a["state"]), tree_leaves(b["state"])))


def test_sharded_run_resumes_bit_for_bit_and_its_checkpoint_restores_anywhere(tmp_path):
    """Reduced llama3.2-1b on the (2, 2, 2) mesh through the driver: stopped
    after step 2 (a checkpoint each step) and resumed to 3. As in the
    reference, the resumed run draws its batches from the stream's start
    again, so its third step is the uninterrupted run's state at step 2
    stepped on the stream's first batch: that, bit for bit, losses and
    state. The checkpoint restores into an unmeshed run, which takes the
    same third step within rounding, and into the reference's
    ``Checkpointer`` with the reference's own state as its template."""
    cfg = config("llama3.2-1b")
    mesh = port_mesh("2x2x2")
    kw = dict(batch=4, seq=8, device="cpu", verbose=False, mesh=mesh)
    whole = port_train.train(cfg, steps=3, **kw)
    ck = str(tmp_path / "ck")
    first = port_train.train(cfg, steps=2, ckpt_dir=ck, ckpt_every=1, **kw)
    assert first["losses"] == whole["losses"][:2]
    resumed = port_train.train(cfg, steps=3, ckpt_dir=ck, ckpt_every=1, **kw)
    assert resumed["start"] == 2 and len(resumed["losses"]) == 1
    with dist.use_mesh(mesh):
        state, metrics = make_train_step(cfg)(sharded.shard_state(cfg, first["state"], mesh),
                                              next(token_stream(cfg.vocab_size, seed=0, batch=4, seq=8)))
    assert resumed["losses"] == [float(metrics["loss"])]
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(resumed["state"]),
                                                 tree_leaves(sharded.gather_state(state))))

    import shutil

    shutil.copytree(os.path.join(ck, "step_0000000002"), str(tmp_path / "ck3" / "step_0000000002"))
    cont = port_train.train(cfg, steps=3, batch=4, seq=8, device="cpu", verbose=False, ckpt_dir=str(tmp_path / "ck3"))
    assert cont["start"] == 2 and abs(cont["losses"][0] - resumed["losses"][0]) <= 1e-6 * abs(resumed["losses"][0])
    for x, y in zip(tree_leaves(cont["state"]), tree_leaves(resumed["state"])):
        torch.testing.assert_close(x, y, rtol=0, atol=5e-5)

    import jax
    import jax.numpy as jnp

    from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
    from repro.configs import ARCH_REGISTRY as JAX_ARCHS
    from repro.configs.base import reduced_config as jax_reduced
    from repro.models.model import init_params as jax_init
    from repro.models.steps import TrainState as JaxState
    from repro.models.steps import make_optimizer as jax_optimizer

    jcfg = case_config(JAX_ARCHS, jax_reduced, "llama3.2-1b")
    p = jax_init(jcfg, jax.random.PRNGKey(0))
    like = jax.tree_util.tree_map(np.asarray, JaxState(p, jax_optimizer(jcfg).init(p), jnp.zeros((), jnp.int32)))
    step, tree, _ = JaxCheckpointer(ck).restore_latest(like=like)
    assert step == 3
    for x, y in zip(tree_leaves(resumed["state"]), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_outside_the_slice_a_mesh_raises_naming_the_roadmap_item():
    """Every arch of the zoo runs on a mesh now; what still raises is a
    split the sharded compute does not know: the view names the leaf and
    its spec (here the MoE router, replicated by the rules, cut over the
    experts by hand)."""
    cfg = reduced_config(ARCH_REGISTRY["granite-moe-3b-a800m"])
    mesh = port_mesh("2x4")
    params = weights(cfg)
    specs = param_shardings_flat(cfg, mesh, params)
    names = [n for n, _ in tree_flatten_with_names(params)]
    i = names.index(("blocks", "slot0", "ffn", "router"))
    specs[i] = (None, None, "model")
    with pytest.raises(ValueError, match=r"blocks/slot0/ffn/router \(2, 64, 4\) is placed \(None, None, 'model'\)"):
        sharded.view(sharded.shard_tree(params, specs, mesh), 0)
    out = port_serve.serve(cfg, batch=2, prompt=4, gen=1, device="cpu", mesh=mesh, verbose=False)
    assert out["tokens"].shape == (2, 1)


def test_each_shard_launches_the_flash_kernel_once_a_layer():
    """The per-shard structure: on CPU tensors the wrappers take the plain
    version and count nothing, so count ``_Attention`` calls instead: one a
    (batch shard, head shard) and layer."""
    cfg = config("llama3.2-1b")
    mesh = port_mesh("2x4")
    params = weights(cfg)
    placed = sharded.shard_tree(params, param_shardings_flat(cfg, mesh, params), mesh)
    calls = []
    real = ops._Attention.apply
    ops._Attention.apply = lambda q, *a: calls.append(tuple(q.shape)) or real(q, *a)
    try:
        with dist.use_mesh(mesh):
            make_prefill_step(cfg)(placed, {"tokens": torch.from_numpy(inputs(cfg)["tokens"]).long()})
    finally:
        ops._Attention.apply = real
    assert len(calls) == 2 * 4 * cfg.num_layers
    assert set(calls) == {(B // 2, cfg.num_heads // 4, S, cfg.resolved_head_dim)}


@pytest.mark.parametrize("arch", ["pixtral-12b", "hubert-xlarge", "llama3-405b"])
def test_the_other_dense_archs_on_a_mesh_match_the_unmeshed_port(arch):
    """The embeds-input archs forward only (as in the reference), on the
    (2, 4) mesh against the unmeshed forward; reduced llama3-405b also one
    train step (Adafactor: its factored moments and update RMS span whole
    leaves, so the update runs on the gathered leaves)."""
    cfg = reduced_config(ARCH_REGISTRY[arch])
    mesh = port_mesh("2x4")
    params = weights(cfg)
    placed = sharded.shard_tree(params, param_shardings_flat(cfg, mesh, params), mesh)
    rng = np.random.default_rng(2)
    if cfg.embeds_input:
        batch = {"embeds": torch.from_numpy(rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))}
    else:
        batch = {"tokens": torch.from_numpy(inputs(cfg)["tokens"]).long()}
    with torch.no_grad():
        want = forward(cfg, params, batch)[0]
        with dist.use_mesh(mesh):
            got = _sharded_forward(cfg, placed, batch, mesh)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    if cfg.embeds_input:
        return
    assert cfg.train.optimizer == "adafactor"
    opt = make_optimizer(cfg)
    state = TrainState(params, opt.init(params), torch.zeros((), dtype=torch.int32))
    s0, m0 = make_train_step(cfg, opt)(state, inputs(cfg))
    with dist.use_mesh(mesh):
        s1, m1 = make_train_step(cfg, opt)(sharded.shard_state(cfg, state, mesh), inputs(cfg))
    assert abs(float(m1["loss"]) - float(m0["loss"])) <= 1e-6 * abs(float(m0["loss"]))
    for a, b in zip(tree_leaves(sharded.gather_state(s1)), tree_leaves(s0)):
        torch.testing.assert_close(a, b, rtol=0, atol=5e-5)


def test_microbatches_on_a_mesh_match_the_unmeshed_step():
    """Reduced command-r-35b with ZeRO and its 4 microbatches (the full
    config's count) on the (2, 2, 2) mesh: each microbatch's rows split over
    the 4 batch shards, the gradients accumulated as the unmeshed step does."""
    cfg = config("command-r-35b")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, microbatches=4))
    mesh = port_mesh("2x2x2")
    params = weights(cfg)
    rng = np.random.default_rng(3)
    data = {k: rng.integers(0, cfg.vocab_size, (16, 8)).astype(np.int32) for k in ("tokens", "labels")}
    opt = make_optimizer(cfg)
    state = TrainState(params, opt.init(params), torch.zeros((), dtype=torch.int32))
    s0, m0 = make_train_step(cfg, opt)(state, data)
    with dist.use_mesh(mesh):
        s1, m1 = make_train_step(cfg, opt)(sharded.shard_state(cfg, state, mesh), data)
    assert abs(float(m1["loss"]) - float(m0["loss"])) <= 1e-6 * abs(float(m0["loss"]))
    for a, b in zip(tree_leaves(sharded.gather_state(s1)), tree_leaves(s0)):
        torch.testing.assert_close(a, b, rtol=0, atol=5e-5)
