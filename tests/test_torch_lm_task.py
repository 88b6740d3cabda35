"""The port's LM task against the reference's, on the CPU.

The reference's ``tiny_lm`` base (``jax.random.PRNGKey(0)``) and its
initial deltas are handed over as numpy. Identical: the token data and the
delta row's flatten order. Within rtol 1e-5 (atol 1e-5, the rounding that
two layers of O(1) activations accumulate, for logits near zero): the
forward's logits. Bitwise:
``merged`` of an initial delta is the base. One fleet training round for
three clients with mixed epoch budgets and one head-only client within
rtol 1e-4 / atol 1e-6 (``wq`` of the head-only client unchanged), and the
fleet's evaluation and feedback against the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.pytrees import tree_flat_vector as jax_flat
from repro.fl.lm_task import default_lm_task as jax_default_lm_task
from repro.fl.lm_task import make_lm_data as jax_make_lm_data
from repro.models.model import forward as jax_forward
from repro_torch.common.pytrees import flatten_spec, tree_leaves, tree_map
from repro_torch.configs import LayerSpec, get_config
from repro_torch.configs.base import MLASpec
from repro_torch.fl.lm_task import FrozenBase, LMTask, default_lm_task, make_lm_data
from repro_torch.fl.tasks import get_task
from repro_torch.interop import tree_from_numpy, tree_to_numpy
from repro_torch.models.model import forward
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

JTASK = jax_default_lm_task()
BASE_NP = jax.tree_util.tree_map(np.asarray, JTASK.base.params)
DATA = dict(vocab_size=256, n_train=4, n_test=2, seq_len=16, seed=3)


@pytest.fixture(scope="module")
def task():
    return default_lm_task("cpu", base_params=BASE_NP)


def _deltas(seed, n):
    """n initial deltas from the reference with b-factors made non-zero."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        d = jax.tree_util.tree_map(np.array, JTASK.init_params(jax.random.PRNGKey(seed + i)))
        d["head_b"] = (0.05 * rng.standard_normal(d["head_b"].shape)).astype(np.float32)
        for ab in d["wq"].values():
            ab["b"] = (0.05 * rng.standard_normal(ab["b"].shape)).astype(np.float32)
        out.append(d)
    return out


def _stack(trees):
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *trees)


def test_make_lm_data_is_identical():
    for a, b in zip(make_lm_data(5, latent_clusters=2, **DATA), jax_make_lm_data(5, latent_clusters=2, **DATA)):
        for name in ("tokens_train", "labels_train", "tokens_test", "labels_test"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        assert a.latent_cluster == b.latent_cluster and a.n == b.n
        np.testing.assert_array_equal(a.label_histogram(16), b.label_histogram(16))


def test_delta_row_flatten_order_is_identical(task):
    (delta,) = _deltas(0, 1)
    port = tree_from_numpy(delta)
    spec = flatten_spec(port)
    assert spec.dim == 2304
    np.testing.assert_array_equal(spec.flatten(port).numpy(), np.asarray(jax_flat(delta)))
    fresh = task.init_params(torch.Generator().manual_seed(0))
    assert [tuple(x.shape) for x in tree_leaves(fresh)] == [x.shape for x in jax.tree_util.tree_leaves(delta)]


def test_forward_logits_match(task):
    tok = make_lm_data(2, **DATA)[0].tokens_train
    want, _, _ = jax_forward(JTASK.cfg, JTASK.base.params, {"tokens": jnp.asarray(tok)})
    got = forward(task.cfg, task.base.params, {"tokens": torch.from_numpy(tok.astype(np.int64))})[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_merged_initial_delta_is_the_base(task):
    delta = task.init_params(torch.Generator().manual_seed(3))
    tok = torch.from_numpy(make_lm_data(1, **DATA)[0].tokens_train.astype(np.int64))
    base = forward(task.cfg, task.base.params, {"tokens": tok})[0]
    assert torch.equal(forward(task.cfg, task.merged(delta), {"tokens": tok})[0], base)
    batched = tree_map(lambda t: t[None].expand(2, *t.shape), delta)
    assert torch.equal(forward(task.cfg, task.merged(batched), {"tokens": tok[None].expand(2, *tok.shape)})[0],
                       base[None].expand(2, *base.shape))


def _fleet(task, n):
    datasets = make_lm_data(n, **DATA)
    port = task.build_fleet_data(datasets, "cpu", task.buckets)
    ref = JTASK.build_fleet_data(jax_make_lm_data(n, **DATA), lambda x: x, JTASK.buckets)
    return port, ref


def test_fleet_local_train_matches_reference(task):
    deltas = _deltas(10, 3)
    port_fd, ref_fd = _fleet(task, 3)
    lr = np.asarray([0.5, 0.3, 0.5], np.float32)
    epochs = np.asarray([2, 1, 2], np.int32)
    head = np.asarray([0.0, 0.0, 1.0], np.float32)
    want, want_loss = JTASK.fleet_local_train(
        jax.tree_util.tree_map(jnp.asarray, _stack(deltas)), ref_fd.train, jnp.asarray(lr),
        jnp.asarray(epochs), jnp.asarray(head), max_epochs=2,
    )
    got, loss = task.fleet_local_train(
        tree_from_numpy(_stack(deltas)), port_fd.train, torch.from_numpy(lr), torch.from_numpy(epochs),
        torch.from_numpy(head), max_epochs=2,
    )
    got_np = tree_to_numpy(got)
    for g, w in zip(tree_leaves(got_np), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), rtol=1e-5)
    for ab_got, ab_init in zip(got_np["wq"].values(), deltas[2]["wq"].values()):
        np.testing.assert_array_equal(ab_got["a"][2], ab_init["a"])  # head-only: wq untouched
        np.testing.assert_array_equal(ab_got["b"][2], ab_init["b"])
    assert not np.array_equal(got_np["head_b"][2], deltas[2]["head_b"])


def test_fleet_evaluate_and_feedback_match_reference(task):
    deltas = _deltas(20, 4)
    port_fd, ref_fd = _fleet(task, 4)
    params_j = jax.tree_util.tree_map(jnp.asarray, _stack(deltas))
    params_t = tree_from_numpy(_stack(deltas))
    np.testing.assert_allclose(task.fleet_evaluate(params_t, port_fd.test).numpy(),
                               np.asarray(JTASK.fleet_evaluate(params_j, ref_fd.test)), atol=1e-6)
    f_got, s_got = task.fleet_feedback(params_t, port_fd.train, task.buckets)
    f_want, s_want = JTASK.fleet_feedback(params_j, ref_fd.train, JTASK.buckets)
    np.testing.assert_array_equal(f_got.numpy(), np.asarray(f_want))
    np.testing.assert_allclose(s_got.numpy(), np.asarray(s_want), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(port_fd.f_true.numpy(), np.asarray(ref_fd.f_true))


def test_per_client_entry_points_agree_with_the_fleet(task):
    (delta,) = _deltas(30, 1)
    data = make_lm_data(1, **DATA)[0]
    fd = task.build_fleet_data([data], "cpu", task.buckets)
    p = tree_from_numpy(delta)
    one = lambda v, dt=torch.float32: torch.tensor([v], dtype=dt)  # noqa: E731
    trained, loss = task.local_train(p, data, epochs=2, lr=0.5, head_only=False)
    fleet, fleet_loss = task.fleet_local_train(tree_map(lambda t: t[None], p), fd.train, one(0.5),
                                               one(2, torch.int32), one(0.0), max_epochs=2)
    for a, b in zip(tree_leaves(trained), tree_leaves(fleet)):
        assert torch.equal(a, b[0])
    assert float(loss) == float(fleet_loss[0])
    f_pred, f_true, s_soft = task.feedback_inputs(p, data, task.buckets)
    assert f_pred.shape == f_true.shape == s_soft.shape == (16,)
    assert f_pred.sum() == data.tokens_train.size and abs(s_soft.sum() - 1.0) < 1e-5
    assert 0.0 <= task.evaluate(p, data) <= 1.0


@pytest.mark.parametrize("change", [dict(pattern=(LayerSpec("mamba", "dense"),)), dict(mla=MLASpec()),
                                    dict(pattern=(LayerSpec("attn", "moe"),))], ids=str)
def test_configs_outside_the_ported_subset_raise(change):
    """The LM task's per-client query deltas run through dense attention
    layers only: a base with Mamba, MLA or MoE layers raises."""
    cfg = dataclasses.replace(get_config("tiny_lm"), **change)
    with pytest.raises(NotImplementedError, match="not ported"):
        LMTask(FrozenBase({}), cfg)


def test_get_task_resolves_both_tasks():
    assert get_task("mlp").name == "mlp"
    lm = get_task("lm", "cpu")
    assert lm.name == "lm" and lm.device.type == "cpu"
    with pytest.raises(ValueError):
        get_task("vision")
