"""The port's end-to-end per-event EchoPFL run against the reference's.

``run_experiment("har", "echopfl", num_clients=8, max_time=900, seed=0)``
runs in both packages; the port gets the reference's initial MLP and
pretrained broadcast RNN (drawn with ``jax.random``, which torch cannot
reproduce) and runs on the CPU. Identical: up/down events and bytes, the
server's event sequence, the clusters and assignments, the staleness
ledger. The accuracy curve within 0.01 absolute.
"""
import jax
import numpy as np
import pytest

from repro.core.broadcast import pretrain_rnn as jax_pretrain_rnn
from repro.fl.experiment import build_clients as jax_build_clients
from repro.fl.experiment import run_experiment as jax_run_experiment
from repro_torch.fl.experiment import run_experiment
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

ARGS = dict(num_clients=8, max_time=900, seed=0)


@pytest.fixture(scope="module")
def runs():
    _, _, init = jax_build_clients("har", ARGS["num_clients"], seed=ARGS["seed"])
    init_np = [{k: np.asarray(v) for k, v in layer.items()} for layer in init]
    rnn_np = {k: np.asarray(v) for k, v in jax_pretrain_rnn(jax.random.PRNGKey(ARGS["seed"])).items()}
    ref = jax_run_experiment("har", "echopfl", **ARGS)
    port = run_experiment("har", "echopfl", device="cpu", init_params=init_np, rnn_params=rnn_np, **ARGS)
    return ref, port


def test_ledger_and_decisions_are_identical(runs):
    (_, _, js, jr), (_, _, ts, tr) = runs
    for name in ("up_events", "down_events", "up_bytes", "down_bytes", "duration"):
        assert getattr(jr, name) == getattr(tr, name), name
    assert jr.up_series == tr.up_series and jr.down_series == tr.down_series
    assert js.events == ts.events
    assert {e["kind"] for e in ts.events} >= {"broadcast", "expand", "merge"}
    assert js.clustering.assignment == ts.clustering.assignment
    assert sorted(js.clustering.clusters) == sorted(ts.clustering.clusters)
    assert js.staleness.snapshot() == ts.staleness.snapshot()
    assert jr.extra["uploads"] == tr.extra["uploads"]


def test_accuracy_curve_within_tolerance(runs):
    (_, _, _, jr), (_, _, _, tr) = runs
    assert [t for t, _ in jr.curve] == [t for t, _ in tr.curve]
    np.testing.assert_allclose([a for _, a in tr.curve], [a for _, a in jr.curve], atol=0.01, rtol=0)
    assert abs(tr.final_acc - jr.final_acc) <= 0.01
    assert tr.final_acc > 0.5  # the run really learns


def test_port_centers_track_the_reference(runs):
    (_, _, js, _), (_, _, ts, _) = runs
    for cid, c in js.clustering.clusters.items():
        np.testing.assert_allclose(
            ts.clustering.clusters[cid].center_vec.numpy(), np.asarray(c.center_vec),
            rtol=1e-4, atol=1e-5,
        )
