"""The port's MLP and client fleet against ``repro.models.mlp`` /
``repro.fl.fleet`` from the same weights and data (numpy seeds, the
reference's init carried over). Tolerance rtol 1e-5 / atol 1e-6: the two
frameworks sum matrix products and reductions in different orders."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.client import SimClient as JaxClient
from repro.fl.fleet import ClientFleet as JaxFleet
from repro.models import mlp as jmlp
from repro_torch.configs.paper_tasks import MLPTaskConfig
from repro_torch.core.client import SimClient
from repro_torch.data.synthetic import make_task
from repro_torch.fl.fleet import ClientFleet
from repro_torch.interop import tree_from_numpy, tree_to_numpy
from repro_torch.models import mlp
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

TOL = dict(rtol=1e-5, atol=1e-6)
CFG = MLPTaskConfig("tiny", 12, (10, 8), 4)


def _init(seed, K=None):
    rng = np.random.default_rng(seed)
    dims = (CFG.input_dim, *CFG.hidden, CFG.num_classes)
    lead = () if K is None else (K,)
    return [
        {"w": (rng.standard_normal(lead + (a, b)) / np.sqrt(a)).astype(np.float32),
         "b": (0.1 * rng.standard_normal(lead + (b,))).astype(np.float32)}
        for a, b in zip(dims[:-1], dims[1:])
    ]


def _jax(tree):
    return [{k: jnp.asarray(v) for k, v in layer.items()} for layer in tree]


def _close(got_tree, want_tree):
    for g, w in zip(got_tree, want_tree):
        for k in ("w", "b"):
            np.testing.assert_allclose(np.asarray(g[k]), np.asarray(w[k]), **TOL)


def _batch(seed, K=4, n=20):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((K, n, CFG.input_dim)).astype(np.float32)
    y = rng.integers(0, CFG.num_classes, (K, n)).astype(np.int32)
    lens = [n, n - 5, 7, n - 1]
    mask = np.stack([(np.arange(n) < L).astype(np.float32) for L in lens[:K]])
    x = x * mask[:, :, None]  # padded samples are zero rows, as pad_rows builds them
    return x, y, mask


def test_fleet_local_train_ragged_epochs_head_only_and_padded_rows():
    K = 4
    p_np = _init(1, K)
    x, y, mask = _batch(2, K)
    lr = np.asarray([0.1, 0.05, 0.1, 0.2], np.float32)
    epochs = np.asarray([5, 3, 0, 5], np.int32)  # row 2 is a padded row: 0 epochs
    head = np.asarray([0.0, 1.0, 0.0, 1.0], np.float32)
    want, wloss = jmlp.fleet_local_train(
        _jax(p_np), jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask), jnp.asarray(lr),
        jnp.asarray(epochs), jnp.asarray(head), max_epochs=5,
    )
    got, gloss = mlp.fleet_local_train(
        tree_from_numpy(p_np), torch.tensor(x), torch.tensor(y).long(), torch.tensor(mask),
        torch.tensor(lr), torch.tensor(epochs), torch.tensor(head), max_epochs=5,
    )
    _close(tree_to_numpy(got), want)
    np.testing.assert_allclose(gloss.numpy(), np.asarray(wloss), **TOL)
    # the 0-epoch row is untouched; head-only rows keep their body exactly
    for layer_np, layer_t in zip(p_np, got):
        np.testing.assert_array_equal(layer_t["w"][2].numpy(), layer_np["w"][2])
    for i in (0, 1):
        np.testing.assert_array_equal(got[i]["w"][1].numpy(), p_np[i]["w"][1])
        np.testing.assert_array_equal(got[i]["b"][3].numpy(), p_np[i]["b"][3])
    assert not np.array_equal(got[2]["w"][1].numpy(), p_np[2]["w"][1])  # the head moved


def test_fleet_evaluate_and_distributions_match():
    K = 4
    p_np = _init(3, K)
    x, y, mask = _batch(4, K)
    pt = tree_from_numpy(p_np)
    acc = mlp.fleet_evaluate(pt, torch.tensor(x), torch.tensor(y).long(), torch.tensor(mask))
    want = jmlp.fleet_evaluate(_jax(p_np), jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask))
    np.testing.assert_allclose(acc.numpy(), np.asarray(want), **TOL)
    h, s = mlp.fleet_predict_distributions(pt, torch.tensor(x), torch.tensor(mask), CFG.num_classes)
    hw, sw = jmlp.fleet_predict_distributions(_jax(p_np), jnp.asarray(x), jnp.asarray(mask),
                                              CFG.num_classes)
    np.testing.assert_array_equal(h.numpy(), np.asarray(hw))
    np.testing.assert_allclose(s.numpy(), np.asarray(sw), **TOL)


@pytest.mark.parametrize("head_only", [False, True])
def test_per_client_local_train_and_evaluate(head_only):
    p_np = _init(5)
    x, y, _ = _batch(6, 1)
    got, gl = mlp.local_train(tree_from_numpy(p_np), torch.tensor(x[0]), torch.tensor(y[0]).long(),
                              epochs=4, lr=0.1, head_only=head_only)
    want, wl = jmlp.local_train(_jax(p_np), jnp.asarray(x[0]), jnp.asarray(y[0]),
                                epochs=4, lr=0.1, head_only=head_only)
    _close(tree_to_numpy(got), want)
    np.testing.assert_allclose(float(gl), float(wl), **TOL)
    np.testing.assert_allclose(float(mlp.evaluate(got, torch.tensor(x[0]), torch.tensor(y[0]).long())),
                               float(jmlp.evaluate(want, jnp.asarray(x[0]), jnp.asarray(y[0]))), **TOL)


def _clients(cls, task, partial=()):
    return [
        cls(client_id=i, data=d, num_classes=task.num_classes, device_class="D1",
            round_time_fn=lambda: 1.0, local_epochs=3 + i % 3, partial_finetune=i in partial)
        for i, d in enumerate(task.clients)
    ]


def test_client_fleet_train_eval_feedback_match_reference():
    task = make_task("har", 5, np.random.default_rng(7), samples_per_client=24)
    cfg_dims = (64, 10, 8, 6)  # har's input and classes, narrow hidden layers
    p0 = _init_dims(cfg_dims, 10)
    jf = JaxFleet(_clients(JaxClient, task, partial={1}), _jax(p0), mesh=False)
    tf = ClientFleet(_clients(SimClient, task, partial={1}), tree_from_numpy(p0), device="cpu")
    for cid in range(5):
        jf.set_model(cid, _jax(p0))
        tf.set_model(cid, tree_from_numpy(p0))
    for cid in (0, 1, 3):
        want, _ = jf.train_client(cid)
        got, _ = tf.train_client(cid)
        _close(tree_to_numpy(got), want)
    # a 3-row cohort pads to 4: the padded row trains 0 epochs and is dropped
    idx = np.asarray([0, 2, 4])
    mat_t = torch.stack([tf.model_vec(c) for c in idx])
    mat_j = jnp.stack([jf.model_vec(int(c)) for c in idx])
    vt, lt = tf._train(idx, mat_t, *tf._train_specs(list(idx)))
    vj, lj = jf._train(idx, mat_j, *jf._train_specs([int(c) for c in idx]))
    assert vt.shape == (3, tf.spec.dim)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), **TOL)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    params = [None, _jax(p0), None, None, _jax(p0)]
    acc_j = jf.evaluate_fleet(params)
    acc_t = tf.evaluate_fleet([None if p is None else tree_from_numpy(p0) for p in params])
    np.testing.assert_allclose(acc_t, acc_j, **TOL)
    center = _init_dims(cfg_dims, 11)
    cj, ct = _jax(center), tree_from_numpy(center)
    pairs = [0, 3, 4, 3]
    fj = jf.feedback_many([(m, cj) for m in pairs])
    ft = tf.feedback_many([(m, ct) for m in pairs])
    np.testing.assert_array_equal(ft[0].numpy(), fj[0])
    np.testing.assert_array_equal(ft[1].numpy(), fj[1])
    np.testing.assert_allclose(ft[2].numpy(), fj[2], **TOL)


def _init_dims(dims, seed):
    rng = np.random.default_rng(seed)
    return [
        {"w": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
         "b": np.zeros(b, np.float32)}
        for a, b in zip(dims[:-1], dims[1:])
    ]
