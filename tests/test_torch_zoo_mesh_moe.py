"""The MoE and MLA archs on model meshes: reduced deepseek-v2-lite-16b (MLA,
a dense prefix layer, MoE with shared experts) and granite-moe-3b-a800m,
the port's sharded forward, prefill, decode and train step against the
reference's sharded step functions (``torch_model_mesh_common``: a child
interpreter on a forced 8-device host, ``Auto`` axes, the port's weights).

Meshes (2, 4) and (4, 2) ``("data", "model")`` and (2, 2, 2) ``("pod",
"data", "model")``. The reduced configs route with capacity (``moe_dropless``
off), so the train step holds the grouped capacity to the reference's.

* Forward and prefill logits within 2e-5 of the reference's and of the
  unmeshed port's (the reference's own meshed-against-unmeshed gap is
  5.2e-6 at most here); greedy tokens equal to both.
* One train step: the loss within 1e-6 relative, every parameter within
  5e-5 of the reference's and the unmeshed port's (the reference's own
  gap, 1.8e-5 at deepseek on (2, 4): AdamW's first step moves a weight by
  the learning rate wherever its gradient is far above eps, whatever the
  gradient's rounding). That check alone would pass a wrong backward
  whose step keeps each gradient's sign, so the first step's gradients
  are held leaf by leaf too: within GRAD_RTOL of each leaf's max |g| of
  the reference's meshed run and of the unmeshed port's (the gaps are
  some 2e-6 here).
* Each split of the placement table is exercised, named by its leaf.
* The capacity follows the reference's group over the whole batch: two
  data shards, one group of 64 tokens, C = 40, where each shard alone
  would take C = 20 and drop pairs the group keeps.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro_torch.common.pytrees import tree_flatten_with_names, tree_leaves
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as port_serve
from repro_torch.launch import sharded
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shardings import param_shardings_flat
from repro_torch.launch.specs import param_specs
from repro_torch.models import dist
from repro_torch.models import layers as L
from repro_torch.models.steps import make_prefill_step
from torch_model_mesh_common import (B, CPU, MESHES, S, config, grad_gaps, inputs, place, port_mesh, port_run,
                                     reference_runs, weights)
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

CASES = ("deepseek-v2-lite-16b", "granite-moe-3b-a800m")
CASE_IDS = [(a, m) for a in CASES for m in MESHES]
LOGITS_ATOL, PARAMS_ATOL = 2e-5, 5e-5
GRAD_RTOL = 2e-5  # of each leaf's max |g|


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ref = reference_runs(CASE_IDS, tmp_path_factory.mktemp("zoo_mesh_moe"), grads=True)
    return {"reference": ref, "port": {key: port_run(*key, grads=True) for key in CASE_IDS},
            "single": {arch: port_run(arch, None, grads=True) for arch in CASES}}


@pytest.mark.parametrize("arch,mesh", CASE_IDS)
def test_sharded_forward_and_prefill_match_the_reference(runs, arch, mesh):
    got, want, single = runs["port"][(arch, mesh)], runs["reference"][(arch, mesh)], runs["single"][arch]
    for key in ("forward", "prefill"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=LOGITS_ATOL)
        np.testing.assert_allclose(got[key], single[key], rtol=0, atol=LOGITS_ATOL)


@pytest.mark.parametrize("arch,mesh", CASE_IDS)
def test_sharded_decode_tokens_equal_the_references(runs, arch, mesh):
    got = runs["port"][(arch, mesh)]["tokens"]
    np.testing.assert_array_equal(got, runs["reference"][(arch, mesh)]["tokens"])
    np.testing.assert_array_equal(got, runs["single"][arch]["tokens"])


@pytest.mark.parametrize("arch,mesh", CASE_IDS)
def test_sharded_capacity_train_step_matches_the_reference(runs, arch, mesh):
    got, want, single = runs["port"][(arch, mesh)], runs["reference"][(arch, mesh)], runs["single"][arch]
    assert not config(arch).moe_dropless
    assert abs(got["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"])
    assert abs(got["loss"] - single["loss"]) <= 1e-6 * abs(single["loss"])
    for a, b, c in zip(tree_leaves(got["params"]), jax.tree_util.tree_leaves(want["params"]),
                       tree_leaves(single["params"])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=PARAMS_ATOL)
        np.testing.assert_allclose(a, c, rtol=0, atol=PARAMS_ATOL)


@pytest.mark.parametrize("arch,mesh", CASE_IDS)
def test_sharded_first_step_gradients_match_the_reference(runs, arch, mesh):
    """The loss's gradient at the initial params through the sharded
    backward (expert-parallel ``wg``/``wu``, the period-split ``wd``, MLA's
    head split and ``w_dkv``'s column blocks, the grouped routing), leaf by
    leaf against the reference's meshed run and the unmeshed port's."""
    got = runs["port"][(arch, mesh)]["grads"]
    for want in (runs["reference"][(arch, mesh)]["grads"], runs["single"][arch]["grads"]):
        gaps = grad_gaps(got, want)
        worst = max(gaps, key=gaps.get)
        assert gaps[worst] <= GRAD_RTOL, (worst, gaps[worst])


def _leaf(view, path: str):
    node = view
    for key in path.split("/"):
        node = node[int(key)] if isinstance(node, list) else node[key]
    return node


def _spec(cfg, mesh, params, path: str):
    names = ["/".join(str(k) for k in n if k is not None) for n, _ in tree_flatten_with_names(params)]
    return param_shardings_flat(cfg, mesh, params)[names.index(path)]


def test_every_split_kind_is_exercised():
    """The table's splits at reduced size, by leaf: deepseek on (2, 4) has
    its experts split one a rank (expert parallel) and ``wd`` whole over
    ``model``, MLA's heads split and ``w_dkv``'s column blocks (24 in
    blocks of 6) straddling the latent/rope cut at 16; on (4, 2) granite's
    and deepseek's ``wd`` split on the period dim, read whole a layer from
    the rank that holds it. At full width on the pod mesh the specs are the
    table's (granite's 24 heads and 40 experts replicated, deepseek's
    ``wd`` ZeRO over ``data``). A prefill on each reduced mesh goes through
    the expert-parallel and period-split MoE and MLA's head-split flash."""
    ds, gr = config("deepseek-v2-lite-16b"), config("granite-moe-3b-a800m")
    mesh = port_mesh("2x4")
    view = sharded.view(place(ds, weights(ds), mesh), 1)
    wg = _leaf(view, "blocks/slot0/ffn/wg")
    assert isinstance(wg, dist.Ranks) and wg.meta == 0 and tuple(wg[0].shape) == (2, 1, 64, ds.moe.d_expert)
    assert isinstance(_leaf(view, "blocks/slot0/ffn/wd"), torch.Tensor)
    for path, dim in (("blocks/slot0/mixer/wq", 1), ("blocks/slot0/mixer/w_ukv", 1), ("blocks/slot0/mixer/wo", 0),
                      ("prefix/0/mixer/wq", 1)):
        assert _leaf(view, path).meta == dim, path
    w_dkv = _leaf(view, "blocks/slot0/mixer/w_dkv")
    width = w_dkv[0].shape[-1]
    assert w_dkv.meta == 1 and width == 6 and any(m * width < ds.mla.kv_lora_rank < (m + 1) * width for m in range(4))
    for cfg in (gr, ds):
        params = weights(cfg)
        mesh = port_mesh("4x2")
        assert _spec(cfg, mesh, params, "blocks/slot0/ffn/wd")[0] == "model"
        wd = _leaf(sharded.view(place(cfg, params, mesh), 0), "blocks/slot0/ffn/wd")
        assert isinstance(wd, sharded.Periods) and wd.model_dim is None
        assert tuple(wd[1].shape) == tuple(params["blocks"]["slot0"]["ffn"]["wd"][1].shape)
        assert torch.equal(wd[1], params["blocks"]["slot0"]["ffn"]["wd"][1])
    pod = make_production_mesh(devices=[CPU] * 256)
    full_gr, full_ds = get_config("granite-moe-3b-a800m"), get_config("deepseek-v2-lite-16b")
    specs_gr, specs_ds = param_specs(full_gr, torch.float32), param_specs(full_ds, torch.float32)
    assert _spec(full_gr, pod, specs_gr, "blocks/slot0/ffn/wd") == ("model", None, None, None)
    for path in ("blocks/slot0/mixer/wq", "blocks/slot0/mixer/wk", "blocks/slot0/ffn/wg", "blocks/slot0/ffn/wu"):
        assert not any(_spec(full_gr, pod, specs_gr, path)), path
    assert _spec(full_ds, pod, specs_ds, "blocks/slot0/ffn/wg") == (None, "model", None, None)
    assert _spec(full_ds, pod, specs_ds, "blocks/slot0/ffn/wd") == (None, "data", None, None)
    assert _spec(full_ds, pod, specs_ds, "blocks/slot0/mixer/w_dkv") == (None, "data", "model")

    seen = []
    shards, mla = L.apply_moe_ffn_shards, L._apply_mla_ranks

    def spy_moe(ps, xs, cfg, *a, **kw):
        seen.append((cfg.name, type(ps[0]["wg"]).__name__, type(ps[0]["wd"]).__name__, len(xs)))
        return shards(ps, xs, cfg, *a, **kw)

    def spy_mla(params, x, cfg, **kw):
        seen.append((cfg.name, "mla", len(params["wq"])))
        return mla(params, x, cfg, **kw)

    L.apply_moe_ffn_shards, L._apply_mla_ranks = spy_moe, spy_mla
    try:
        for cfg, name in ((ds, "2x4"), (gr, "4x2")):
            mesh = port_mesh(name)
            with dist.use_mesh(mesh):
                make_prefill_step(cfg)(place(cfg, weights(cfg), mesh), {"tokens": torch.from_numpy(inputs(cfg)["tokens"])})
    finally:
        L.apply_moe_ffn_shards, L._apply_mla_ranks = shards, mla
    assert (ds.name, "Ranks", "Tensor", 2) in seen and (ds.name, "mla", 4) in seen
    assert (gr.name, "Ranks", "Tensor", 4) in seen  # 4 experts over 2 ranks; wd read whole a layer


def test_grouped_capacity_spans_the_batch_shards():
    """Two data shards of 32 tokens, one reference group of 64: C = ceil(2 x
    64 x 1.25 / 4) = 40 over the group, as the unmeshed layer computes,
    where a shard alone would take C = 20 and drop pairs that the group
    keeps. The shards together give the whole batch's output and aux."""
    cfg = config("granite-moe-3b-a800m")
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    p = {k: v[0] for k, v in weights(cfg)["blocks"]["slot0"]["ffn"].items()}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((B, S, cfg.d_model)).astype(np.float32))
    whole, aux = L.apply_moe_ffn(p, x, cfg)
    ys, aux_shards = L.apply_moe_ffn_shards([p, p], [x[: B // 2], x[B // 2:]], cfg)
    torch.testing.assert_close(torch.cat(ys), whole, rtol=0, atol=1e-6)
    torch.testing.assert_close(aux_shards, aux, rtol=0, atol=1e-7)

    def queue_places(tokens):
        probs = torch.softmax(tokens.reshape(1, -1, cfg.d_model) @ p["router"], dim=-1)
        flat = torch.nn.functional.one_hot(L.top_k(probs, K)[1], E).reshape(1, -1, E)
        return torch.amax(torch.sum(flat, dim=1)).item()  # the busiest expert's pairs

    group_c = int(np.ceil(K * B * S * 1.25 / E))
    shard_c = int(np.ceil(K * (B // 2) * S * 1.25 / E))
    assert (group_c, shard_c) == (40, 20)
    busiest = [queue_places(x[: B // 2]), queue_places(x[B // 2:])]
    assert max(busiest) > shard_c and queue_places(x) <= group_c  # a shard alone would drop; the group does not
    alone = torch.cat([L.apply_moe_ffn(p, x[: B // 2], cfg)[0], L.apply_moe_ffn(p, x[B // 2:], cfg)[0]])
    assert (alone - whole).abs().max() > 1e-3


def test_dropless_serving_on_a_mesh_is_the_unmeshed_run():
    """Dropless, every group gives each token's own result: reduced
    deepseek served on (2, 4) has the unmeshed run's tokens and logits."""
    cfg = dataclasses.replace(config("deepseek-v2-lite-16b"), moe_dropless=True)
    kw = dict(batch=B, prompt=S, gen=3, device="cpu", keep_logits=True, verbose=False)
    plain = port_serve.serve(cfg, **kw)
    meshed = port_serve.serve(cfg, mesh=port_mesh("2x4"), **kw)
    np.testing.assert_array_equal(plain["tokens"], meshed["tokens"])
    for a, b in zip(plain["logits"], meshed["logits"]):
        torch.testing.assert_close(b, a, rtol=0, atol=LOGITS_ATOL)


def test_mla_runs_the_flash_kernel_once_a_head_shard():
    """MLA's prefill on (2, 4): one ``_Attention`` call a (batch shard, model
    rank) and layer, each of one head at head width nope + rope (value
    width v): the structure of the pod mesh's 27 x 16 x 16 launches. CPU
    tensors take the plain version and count nothing, so count the calls."""
    cfg = config("deepseek-v2-lite-16b")
    mesh = port_mesh("2x4")
    calls = []
    real = ops._Attention.apply
    ops._Attention.apply = lambda q, k, v, *a: calls.append((tuple(q.shape), v.shape[-1])) or real(q, k, v, *a)
    try:
        with dist.use_mesh(mesh):
            make_prefill_step(cfg)(place(cfg, weights(cfg), mesh), {"tokens": torch.from_numpy(inputs(cfg)["tokens"])})
    finally:
        ops._Attention.apply = real
    m = cfg.mla
    assert len(calls) == 2 * 4 * cfg.num_layers
    assert set(calls) == {((B // 2, 1, S, m.qk_nope_head_dim + m.qk_rope_head_dim), m.v_head_dim)}
