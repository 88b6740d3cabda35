"""The port's end-to-end per-event EchoPFL run on the LM task against the
reference's.

``run_lm_experiment("echopfl", num_clients=8, max_time=900,
eval_interval=120, seed=0)`` runs in both packages; the port gets the
reference's ``tiny_lm`` base, initial delta and pretrained broadcast RNN
(drawn with ``jax.random``, which torch cannot reproduce) and runs on the
CPU. Identical: up/down events and bytes, the server's event sequence (with
broadcasts and expansions), the assignments and the staleness ledger. The
accuracy curve within 0.01 absolute, the centers within rtol 1e-4.
"""
import jax
import numpy as np
import pytest

from repro.core.broadcast import pretrain_rnn as jax_pretrain_rnn
from repro.fl.lm_task import default_lm_task as jax_default_lm_task
from repro.fl.lm_task import run_lm_experiment as jax_run_lm_experiment
from repro_torch.fl.lm_task import run_lm_experiment
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

ARGS = dict(num_clients=8, max_time=900, eval_interval=120, seed=0)


@pytest.fixture(scope="module")
def runs():
    jtask = jax_default_lm_task()
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    base_np = to_np(jtask.base.params)
    delta_np = to_np(jtask.init_params(jax.random.PRNGKey(ARGS["seed"])))
    rnn_np = to_np(jax_pretrain_rnn(jax.random.PRNGKey(ARGS["seed"])))
    ref = jax_run_lm_experiment("echopfl", **ARGS)
    port = run_lm_experiment("echopfl", device="cpu", base_params=base_np, init_params=delta_np,
                             rnn_params=rnn_np, **ARGS)
    return ref, port


def test_ledger_and_decisions_are_identical(runs):
    (_, _, js, jr), (_, _, ts, tr) = runs
    for name in ("up_events", "down_events", "up_bytes", "down_bytes", "duration"):
        assert getattr(jr, name) == getattr(tr, name), name
    assert jr.up_bytes == jr.up_events * 2304 * 4  # billed at delta size
    assert jr.up_series == tr.up_series and jr.down_series == tr.down_series
    assert js.events == ts.events
    assert {e["kind"] for e in ts.events} >= {"broadcast", "expand"}
    assert js.clustering.assignment == ts.clustering.assignment
    assert sorted(js.clustering.clusters) == sorted(ts.clustering.clusters)
    assert js.staleness.snapshot() == ts.staleness.snapshot()
    assert jr.extra["uploads"] == tr.extra["uploads"]


def test_accuracy_curve_within_tolerance(runs):
    (_, _, _, jr), (_, _, _, tr) = runs
    assert [t for t, _ in jr.curve] == [t for t, _ in tr.curve]
    np.testing.assert_allclose([a for _, a in tr.curve], [a for _, a in jr.curve], atol=0.01, rtol=0)


def test_port_centers_track_the_reference(runs):
    (_, _, js, _), (_, _, ts, _) = runs
    for cid, c in js.clustering.clusters.items():
        got = ts.clustering.clusters[cid].center_vec.numpy()
        assert got.shape == (2304,) and np.isfinite(got).all()
        np.testing.assert_allclose(got, np.asarray(c.center_vec), rtol=1e-4, atol=1e-6)
