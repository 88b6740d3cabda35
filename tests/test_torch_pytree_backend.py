"""The port's pytree plane backend (``plane_backend="pytree"``) on the CPU.

Against the reference's pytree backend (``REPRO_PLANE=pytree``, set for
the reference only and restored) and the port's own plane backend, with
the reference's initial MLP and broadcast RNN handed over:

* ``har``, 8 clients, 900 s, per event: the ledgers, events, assignments,
  staleness and ``stats()`` equal the reference's (the feedback means
  within rtol 1e-5, floats of one chi2 sum); the port's pytree run equals
  its plane run field for field, centers and anchors bit for bit, with
  ``backend: "pytree"`` and ``plane_rows: 0``;
* the coalesced loop (45 s windows) in pytree mode equals the plane
  backend's coalesced run and never calls ``ingest_chain``;
  ``handle_uploads`` in pytree mode equals sequential ``handle_upload``
  bit for bit;
* the guard's rollback restores from the tree snapshot ring, and a guard
  whose center check fails on a schedule rolls back as the reference's
  pytree server does;
* a pytree-mode checkpoint has the reference's paths, and one written
  mid-stream by either package restores into the other's pytree server,
  which goes on with the same decisions.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jck
from repro.core.broadcast import pretrain_rnn as jax_pretrain_rnn
from repro.core.server import EchoPFLServer as JaxServer
from repro.fl import guard as jg
from repro.fl.experiment import build_clients as jax_build_clients
from repro.fl.experiment import build_strategy as jax_build_strategy
from repro.fl.experiment import run_experiment as jax_run_experiment
from repro.fl.network import NetworkModel as JaxNetwork
from repro.fl.simulator import Simulator as JaxSimulator
from repro_torch.checkpoint import checkpointer as tck
from repro_torch.checkpoint import restore_pytree, save_pytree
from repro_torch.common.pytrees import tree_flat_vector
from repro_torch.core import server as server_mod
from repro_torch.core.server import EchoPFLServer
from repro_torch.fl import guard as tg
from repro_torch.fl.experiment import build_clients, build_strategy, run_experiment
from repro_torch.fl.simulator import Simulator
from repro_torch.interop import tree_from_numpy
from test_torch_coalesce import _assert_servers_equal, _batched, _noisy_stream
from test_torch_guard import _failing
from test_torch_restart import SPLIT, _assert_close_meta, _bits, _feed, _json, _server_kw, _stream
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

ARGS = dict(num_clients=8, max_time=900, seed=0)
LEDGER = ("up_events", "down_events", "up_bytes", "down_bytes", "duration", "up_series", "down_series")


@pytest.fixture(autouse=True)
def _no_repro_env(monkeypatch):
    for name in [k for k in os.environ if k.startswith("REPRO_")]:
        monkeypatch.delenv(name)


@pytest.fixture(scope="module")
def weights():
    _, _, init = jax_build_clients("har", ARGS["num_clients"], seed=ARGS["seed"])
    init_np = [{k: np.asarray(v) for k, v in layer.items()} for layer in init]
    rnn_np = {k: np.asarray(v) for k, v in jax_pretrain_rnn(jax.random.PRNGKey(ARGS["seed"])).items()}
    return init_np, rnn_np


def _reference(fn, *a, **kw):
    """Call into the reference with ``REPRO_PLANE=pytree``, restoring the
    variable afterwards."""
    old = os.environ.get("REPRO_PLANE")
    os.environ["REPRO_PLANE"] = "pytree"
    try:
        return fn(*a, **kw)
    finally:
        if old is None:
            del os.environ["REPRO_PLANE"]
        else:
            os.environ["REPRO_PLANE"] = old


@pytest.fixture(scope="module")
def har_runs(weights):
    init_np, rnn_np = weights
    saved = {k: os.environ.pop(k) for k in [k for k in os.environ if k.startswith("REPRO_")]}
    try:
        ref = _reference(jax_run_experiment, "har", "echopfl", **ARGS)
        port = {b: run_experiment("har", "echopfl", device="cpu", init_params=init_np, rnn_params=rnn_np,
                                  plane_backend=b, **ARGS) for b in ("pytree", "plane")}
    finally:
        os.environ.update(saved)
    return ref, port


def _stats_equal(a: dict, b: dict, skip=()):
    a, b = dict(a), dict(b)
    fa, fb = a.pop("cluster_feedback_mean"), b.pop("cluster_feedback_mean")
    for k in skip:
        a.pop(k), b.pop(k)
    assert a == b
    assert fa.keys() == fb.keys()
    np.testing.assert_allclose([fa[c] for c in fa], [fb[c] for c in fa], rtol=1e-5)


def test_pytree_run_equals_the_references_pytree_run(har_runs):
    (_, _, js, jr), port = har_runs
    _, _, ts, tr = port["pytree"]
    for name in LEDGER:
        assert getattr(jr, name) == getattr(tr, name), name
    assert js.events == ts.events
    assert {e["kind"] for e in ts.events} >= {"broadcast", "expand", "merge"}
    assert js.clustering.assignment == ts.clustering.assignment
    assert js.staleness.snapshot() == ts.staleness.snapshot()
    assert jr.extra["uploads"] == tr.extra["uploads"]
    _stats_equal(js.stats(), ts.stats())
    assert ts.stats()["backend"] == js.stats()["backend"] == "pytree" and ts.stats()["plane_rows"] == 0
    assert ts.clustering.plane is None and len(ts.clustering.uploads) == len(js.last_uploads)
    np.testing.assert_allclose([a for _, a in tr.curve], [a for _, a in jr.curve], atol=0.01, rtol=0)


def test_pytree_run_equals_the_plane_run(har_runs):
    _, port = har_runs
    (_, _, ts, tr), (_, _, ps, pr) = port["pytree"], port["plane"]
    for name in LEDGER:
        assert getattr(tr, name) == getattr(pr, name), name
    assert tr.curve == pr.curve
    assert ts.events == ps.events and ts.clustering.assignment == ps.clustering.assignment
    assert ts.staleness.snapshot() == ps.staleness.snapshot()
    _stats_equal(ts.stats(), ps.stats(), skip=("backend", "plane_rows"))
    assert ps.stats()["plane_rows"] > 0
    for cid, c in ps.clustering.clusters.items():
        t = ts.clustering.clusters[cid]
        assert torch.equal(t.center_vec, c.center_vec) and torch.equal(t.broadcast_vec, c.broadcast_vec), cid
    assert sorted(ts.clustering.uploads) == sorted(ps.clustering.uploads)
    for k, row in ps.clustering.uploads.items():
        assert torch.equal(tree_flat_vector(ts.clustering.uploads[k]), ps.clustering.plane.row(row))


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="plane|pytree"):
        EchoPFLServer([{"w": torch.zeros(2)}], plane_backend="rows", device="cpu", enable_broadcast=False)


@pytest.fixture
def chains(monkeypatch):
    calls = []
    fn = server_mod.K.ingest_chain

    def rec(U, *a, **kw):
        calls.append(U.shape[0])
        return fn(U, *a, **kw)

    monkeypatch.setattr(server_mod.K, "ingest_chain", rec)
    return calls


def test_coalesced_pytree_run_takes_the_per_upload_path(weights, chains):
    init_np, rnn_np = weights
    kw = dict(num_clients=8, max_time=600, seed=0, device="cpu", init_params=init_np, rnn_params=rnn_np,
              coalesce_window=45.0)
    _, _, ts, tr = run_experiment("har", "echopfl", plane_backend="pytree", **kw)
    assert chains == []
    _, _, ps, pr = run_experiment("har", "echopfl", **kw)
    assert chains and max(chains) > 1
    for name in LEDGER:
        assert getattr(tr, name) == getattr(pr, name), name
    assert ts.events == ps.events and ts.clustering.assignment == ps.clustering.assignment
    assert ts.staleness.snapshot() == ps.staleness.snapshot()
    _stats_equal(ts.stats(), ps.stats(), skip=("backend", "plane_rows"))


def _server(rnn_np, **kw):
    _, clients, init = build_clients("har", 6, seed=3, samples_per_client=48, device="cpu")
    return clients, init, build_strategy("echopfl", init, clients, seed=3, rnn_params=rnn_np, device="cpu",
                                         plane_backend="pytree", **kw)


def test_handle_uploads_in_pytree_mode_is_sequential(weights, chains):
    _, rnn_np = weights
    clients, init, sA = _server(rnn_np)
    _, _, sB = _server(rnn_np)
    stream = _noisy_stream(clients, init)
    outA = [sA.handle_upload(*u) for u in stream]
    outB = _batched(sB, stream, 6)
    _assert_servers_equal(sA, sB, outA, outB)
    assert chains == [] and sA.stats()["plane_rows"] == 0


def test_rollback_restores_the_last_finite_tree_snapshot(weights):
    init_np, rnn_np = weights
    srv = EchoPFLServer(tree_from_numpy(init_np), num_initial_clusters=2, refine_every=1000, rnn_params=rnn_np,
                        device="cpu", plane_backend="pytree")
    srv.attach_guard(tg.IngestGuard(tg.GuardConfig(snapshot_ring=2)))
    for i in range(4):
        srv.handle_upload(i, [{k: v + i * 0.01 for k, v in layer.items()} for layer in srv.init_params], 0, 48,
                          float(i))
    cl = next(iter(srv.clustering.clusters.values()))
    assert cl._snap_trees is not None and cl._snap_rows is None
    nan = [{k: torch.full_like(v, float("nan")) for k, v in layer.items()} for layer in srv.init_params]
    good = cl.center
    cl.snapshot_broadcast()  # the ring's newest entry: the current center
    cl.center = nan
    assert cl.rollback() and torch.equal(cl.center_vec, tree_flat_vector(good))
    cl._snap_trees[(cl._snap_cursor - 1) % 2] = nan  # a corrupt newest snapshot: go older, then the anchor
    cl.center = nan
    assert cl.rollback() and torch.isfinite(cl.center_vec).all()
    cl._snap_trees[:] = [nan, nan]
    cl.last_broadcast_center = nan
    assert not cl.rollback()


def test_forced_center_failures_roll_back_as_the_references_pytree_server(weights):
    init_np, rnn_np = weights
    _, jclients, jinit = jax_build_clients("har", 8, seed=0)
    js = jax_build_strategy("echopfl", jinit, jclients, seed=0, plane_backend="pytree")
    jsim = JaxSimulator(jclients, js, network=JaxNetwork(), seed=0, client_backend="fleet", guard="on")
    jsim._guard = _failing(jg.IngestGuard)(jsim._guard.cfg)
    jr = jsim.run_async(max_time=900.0)
    _, clients, init = build_clients("har", 8, seed=0, device="cpu", init_params=init_np)
    ts = build_strategy("echopfl", init, clients, seed=0, rnn_params=rnn_np, device="cpu", plane_backend="pytree")
    sim = Simulator(clients, ts, seed=0, guard="on")
    sim._guard = _failing(tg.IngestGuard)(sim._guard.cfg)
    tr = sim.run_async(max_time=900.0)
    for name in LEDGER:
        assert getattr(jr, name) == getattr(tr, name), name
    assert jr.extra["guard"] == tr.extra["guard"] and tr.extra["guard"]["rollbacks"] > 3
    assert js.events == ts.events and js.clustering.assignment == ts.clustering.assignment


def _port_server(init, rnn_np):
    return EchoPFLServer(tree_from_numpy(init), rnn_params=rnn_np, device="cpu", plane_backend="pytree",
                         **_server_kw(init))


def _jax_server(init):
    return JaxServer([{k: jnp.asarray(v) for k, v in layer.items()} for layer in init],
                     pretrain_key=jax.random.PRNGKey(0), plane_backend="pytree", **_server_kw(init))


def test_pytree_checkpoint_paths_equal_the_references(weights):
    init, ups = _stream(SPLIT)
    js, ts = _jax_server(init), _port_server(init, weights[1])
    assert _feed(js, ups, 0, False) == _feed(ts, ups, 0, True)
    (jt, jm), (tt, tm) = js.state_dict(), ts.state_dict()
    _assert_close_meta(_json(jm), _json(tm))
    assert tm["upload_clients"] and len(tt["last_uploads"]) == len(tm["upload_clients"])
    jp, jl = jck._paths_and_leaves(jt)
    tp, tl = tck._paths_and_leaves(tt)
    assert jp == tp
    for a, b in zip(jl, tl):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_pytree_checkpoint_resumes_in_the_other_package(weights, tmp_path, writer):
    init, ups = _stream(60)
    js, ts = _jax_server(init), _port_server(init, weights[1])
    d = str(tmp_path / "ckpt")
    if writer == "reference":
        src, dst = js, ts
        _feed(js, ups[:SPLIT], 0, False)
        tree, meta = js.state_dict()
        jck.save_pytree(d, tree, extra=meta)
        dst.load_state(*restore_pytree(d, like=dst.state_template(restore_pytree(d)[1])))
    else:
        src, dst = ts, js
        _feed(ts, ups[:SPLIT], 0, True)
        tree, meta = ts.state_dict()
        save_pytree(d, tree, extra=meta)
        dst.load_state(*jck.restore_pytree(d, like=dst.state_template(jck.restore_pytree(d)[1])))
    assert dst.clustering.plane is None and dst.stats()["backend"] == "pytree"
    _assert_close_meta(_json(src.state_dict()[1]), _json(dst.state_dict()[1]))
    assert _bits(src.state_dict()[0]) == _bits(dst.state_dict()[0])  # the restore itself is exact
    rest = ups[SPLIT:]
    assert _feed(js, rest, SPLIT, False) == _feed(ts, rest, SPLIT, True)
    assert js.events == ts.events and js.clustering.assignment == ts.clustering.assignment
    assert js.staleness.snapshot() == ts.staleness.snapshot() and js.client_versions == ts.client_versions
    _stats_equal(js.stats(), ts.stats())
