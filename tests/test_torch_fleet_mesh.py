"""The client fleet over a mesh, and its data rebuild when a client's
dataset is replaced.

* Counterpart of ``tests/test_client_fleet.py``'s
  ``test_meshed_fleet_matches_single_device``: with a 2- or 4-shard mesh of
  the ``cpu`` device the model rows and the data tensors spread over the
  shards and every batched call runs a batch a shard; training, eval and
  feedback equal the one-device fleet bit for bit. A fleet whose size the
  shards do not divide runs on one device.
* Counterpart of ``test_dataset_replacement_is_picked_up``: a replaced
  ``SimClient.data`` (a larger test set, a new training set) is what the
  next launch uses, as in the reference's fleet.
* A drift run: two clients' data shifted mid-run
  (``FederatedTask.shift_client``, the paper's Fig. 18) in both packages,
  the port's events and assignments the reference's; the meshed port run
  equal to the unmeshed one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.broadcast import pretrain_rnn as jax_pretrain_rnn
from repro.core.client import SimClient as JaxClient
from repro.data.synthetic import ClientDataset as JaxDataset
from repro.fl.experiment import build_clients as jax_build_clients
from repro.fl.experiment import build_strategy as jax_build_strategy
from repro.fl.fleet import ClientFleet as JaxFleet
from repro.fl.simulator import Simulator as JaxSimulator
from repro_torch.core.client import SimClient
from repro_torch.data.synthetic import ClientDataset, make_task
from repro_torch.fl.experiment import build_clients, build_strategy
from repro_torch.fl.fleet import ClientFleet
from repro_torch.fl.simulator import Simulator
from repro_torch.interop import tree_from_numpy, tree_to_numpy
from repro_torch.launch.mesh import make_plane_mesh, resolve_mesh
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

CPU = torch.device("cpu")
DIMS = (64, 10, 8, 6)  # har's input and classes, narrow hidden layers


def cpu_mesh(rows: int):
    return make_plane_mesh(rows, devices=[CPU] * rows)


def _init(seed):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
             "b": (0.1 * rng.standard_normal(b)).astype(np.float32)} for a, b in zip(DIMS[:-1], DIMS[1:])]


def _ragged_task(n_clients=4, seed=7):
    """``har`` clients with unequal train and test sizes."""
    task = make_task("har", n_clients, np.random.default_rng(seed), samples_per_client=24)
    for i, d in enumerate(task.clients):
        keep = len(d.y_train) - 3 * (i % 3)
        task.clients[i] = ClientDataset(d.x_train[:keep], d.y_train[:keep], d.x_test[: 4 + i], d.y_test[: 4 + i],
                                        d.latent_cluster)
    return task


def _clients(cls, task, partial=(1,)):
    return [cls(client_id=i, data=d, num_classes=task.num_classes, device_class="D1", round_time_fn=lambda: 1.0,
                local_epochs=3 + i % 3, lr=0.05 * (1 + i % 2), partial_finetune=i in partial)
            for i, d in enumerate(task.clients)]


def _same(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def _same_trees(ta, tb):
    for x, y in zip(ta, tb):
        for k in ("w", "b"):
            _same(x[k], y[k])


@pytest.mark.parametrize("shards", [2, 4])
def test_meshed_fleet_matches_single_device(shards):
    task = _ragged_task()
    p0 = tree_from_numpy(_init(10))
    single = ClientFleet(_clients(SimClient, task), p0, device="cpu")
    meshed = ClientFleet(_clients(SimClient, task), p0, device="cpu", mesh=cpu_mesh(shards))
    assert meshed.mesh is not None and meshed.plane.sharded
    assert [len(t["x"]) for t in meshed._shard_train] == [4 // shards] * shards  # the data over the shards
    ids = list(range(4))
    ta, la, va = single.train_cohort(ids, [p0] * 4)
    tb, lb, vb = meshed.train_cohort(ids, [p0] * 4)
    _same(va, vb)
    _same(la, lb)
    for f in (single, meshed):
        for c in ids:
            f.set_model(c, p0)
    for c in (3, 0, 2):
        ga, lossa = single.train_client(c)
        gb, lossb = meshed.train_client(c)
        _same_trees(ga, gb)
        _same(lossa, lossb)
    np.testing.assert_array_equal(single.evaluate_fleet([None] * 4), meshed.evaluate_fleet([None] * 4))
    pairs = [(c, p0 if c % 2 else ta[1]) for c in (3, 1, 0, 2, 1)]
    for x, y in zip(single.feedback_many(pairs), meshed.feedback_many(pairs)):
        _same(x, y)
    ra, lra, vra = single.train_rows([2, 0, 3])
    rb, lrb, vrb = meshed.train_rows([2, 0, 3])
    _same(vra, vrb)
    _same(lra, lrb)
    for c in ids:
        _same(single.model_vec(c), meshed.model_vec(c))


def test_meshed_fleet_matches_the_reference_fleet():
    task = _ragged_task()
    p0 = _init(10)
    jp0 = [{k: jnp.asarray(v) for k, v in l.items()} for l in p0]
    jf = JaxFleet(_clients(JaxClient, task), jp0, mesh=False)
    tf = ClientFleet(_clients(SimClient, task), tree_from_numpy(p0), device="cpu", mesh=cpu_mesh(2))
    ids = list(range(4))
    want, lw = jf.train_cohort(ids, [jp0] * 4)
    got, lg, _ = tf.train_cohort(ids, [tree_from_numpy(p0)] * 4)
    for g, w in zip(got, want):
        for lg_, lw_ in zip(tree_to_numpy(g), w):
            for k in ("w", "b"):
                np.testing.assert_allclose(lg_[k], np.asarray(lw_[k]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lg.numpy(), np.asarray(lw), rtol=1e-5, atol=1e-6)


def test_fleet_that_does_not_divide_the_shards_runs_on_one_device():
    task = _ragged_task()
    fleet = ClientFleet(_clients(SimClient, task), tree_from_numpy(_init(10)), device="cpu", mesh=cpu_mesh(8))
    assert fleet.mesh is None and not fleet.plane.sharded
    assert ClientFleet(_clients(SimClient, task), tree_from_numpy(_init(10)), device="cpu",
                       mesh=resolve_mesh("4", "cpu")).mesh is not None


@pytest.mark.parametrize("shards", [None, 2])
def test_dataset_replacement_is_picked_up(shards):
    """A replaced dataset (a drifted client; here a test set three samples
    longer, which widens the padded tensors, and a new training set) is
    what the next evaluation, training and probe use, as in the
    reference's fleet."""
    task = _ragged_task()
    p0 = _init(10)
    jp0 = [{k: jnp.asarray(v) for k, v in l.items()} for l in p0]
    jclients, tclients = _clients(JaxClient, task), _clients(SimClient, task)
    jf = JaxFleet(jclients, jp0, mesh=False)
    tf = ClientFleet(tclients, tree_from_numpy(p0), device="cpu", mesh=None if shards is None else cpu_mesh(shards))
    tf.evaluate_fleet([tree_from_numpy(p0)] * 4)
    rng = np.random.default_rng(99)
    n = len(task.clients[0].y_test) + 3
    x_tr = rng.normal(size=task.clients[0].x_train.shape).astype(np.float32)
    new = dict(x_train=x_tr, y_train=task.clients[0].y_train[::-1].copy(),
               x_test=rng.normal(size=(n, DIMS[0])).astype(np.float32),
               y_test=rng.integers(0, DIMS[-1], size=n).astype(np.int32), latent_cluster=0)
    jclients[0].data = JaxDataset(**new)
    tclients[0].data = ClientDataset(**new)
    got = tf.evaluate_fleet([tree_from_numpy(p0)] * 4)
    want = jf.evaluate_fleet([jp0] * 4)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
    for f, p in ((jf, jp0), (tf, tree_from_numpy(p0))):
        f.set_model(0, p)
    gt, _ = tf.train_client(0)
    wt, _ = jf.train_client(0)
    for g, w in zip(tree_to_numpy(gt), wt):
        for k in ("w", "b"):
            np.testing.assert_allclose(g[k], np.asarray(w[k]), rtol=1e-5, atol=1e-6)
    fp_t, ft_t, _ = tf.feedback_many([(0, tree_from_numpy(p0))])
    fp_j, ft_j, _ = jf.feedback_many([(0, jp0)])
    np.testing.assert_allclose(fp_t.numpy(), np.asarray(fp_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ft_t.numpy(), np.asarray(ft_j))


# ------------------------------------------------------------------ drift run
HORIZON, SHIFT_AT, VICTIMS = 900.0, 450.0, (0, 1)


def _drift(sim, task, clients):
    """Shift the victims' data to the next latent cluster at the first
    evaluation past SHIFT_AT and hand each its new dataset, as a device's
    data would change under it (``benchmarks/bench_drift_adaptation.py``
    shifts the task's list only, which no client reads)."""
    rng = np.random.default_rng(7)
    by_id = {c.client_id: c for c in clients}
    orig = sim._evaluate
    done = []

    def hook(t):
        if not done and t >= SHIFT_AT:
            for v in VICTIMS:
                task.shift_client(v, (task.clients[v].latent_cluster + 1) % len(task.transforms), rng)
                by_id[v].data = task.clients[v]
            done.append(t)
        return orig(t)

    sim._evaluate = hook
    return sim.run(max_time=HORIZON), done


@pytest.fixture(scope="module")
def drift_runs():
    task_j, clients_j, init_j = jax_build_clients("har", 8, seed=0)
    strat_j = jax_build_strategy("echopfl", init_j, clients_j, seed=0)
    rep_j, done_j = _drift(JaxSimulator(clients_j, strat_j, eval_interval=60, seed=0), task_j, clients_j)
    init_np = [{k: np.asarray(v) for k, v in layer.items()} for layer in init_j]
    rnn_np = {k: np.asarray(v) for k, v in jax_pretrain_rnn(jax.random.PRNGKey(0)).items()}
    ports = {}
    for name, meshes in (("single", {}), ("meshed", {"plane_mesh": "8", "fleet_mesh": "4"})):
        task, clients, init = build_clients("har", 8, seed=0, device="cpu", init_params=init_np)
        plane_mesh = resolve_mesh(meshes.get("plane_mesh"), "cpu")
        strat = build_strategy("echopfl", init, clients, seed=0, rnn_params=rnn_np, device="cpu",
                               plane_mesh=plane_mesh, mesh_min_rows=0)
        sim = Simulator(clients, strat, eval_interval=60, seed=0,
                        fleet_mesh=resolve_mesh(meshes.get("fleet_mesh"), "cpu"))
        rep, done = _drift(sim, task, clients)
        ports[name] = (strat, rep, done)
    return (strat_j, rep_j, done_j), ports


def test_drift_run_matches_the_reference(drift_runs):
    (js, jr, jdone), ports = drift_runs
    ts, tr, tdone = ports["single"]
    assert jdone == tdone and jdone
    for name in ("up_events", "down_events", "up_bytes", "down_bytes", "duration"):
        assert getattr(jr, name) == getattr(tr, name), name
    assert js.events == ts.events
    assert js.clustering.assignment == ts.clustering.assignment
    np.testing.assert_allclose([a for _, a in tr.curve], [a for _, a in jr.curve], atol=0.01, rtol=0)


def test_meshed_drift_run_matches_the_unmeshed_run(drift_runs):
    _, ports = drift_runs
    (sa, ra, _), (sb, rb, _) = ports["single"], ports["meshed"]
    assert sb.clustering.plane.sharded
    assert ra.curve == rb.curve and ra.final_acc == rb.final_acc
    assert sa.events == sb.events and sa.clustering.assignment == sb.clustering.assignment
    for cid, c in sa.clustering.clusters.items():
        torch.testing.assert_close(sb.clustering.clusters[cid].center_vec, c.center_vec, rtol=0, atol=0)
