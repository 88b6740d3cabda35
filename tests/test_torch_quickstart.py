"""The port's quickstart (``repro_torch.launch.quickstart``) against the
reference's ``examples/quickstart.py``, on the CPU.

Both run the quickstart's steps (12 ``har`` clients, 4 latent groups,
EchoPFL, evaluation every 120 s, seed 0) for 600 s of virtual time, a
third of the quickstart's 1,800 s, so that the reference's eager run fits
this suite's time. The port gets the reference's initial MLP and its
server's pretrained broadcast RNN. Identical: the event and byte ledgers,
the server's events, ``stats()`` and assignment. The final and per-client
mean accuracy within 0.01.
"""
import os

import numpy as np
import pytest

from repro.fl.experiment import build_clients as jax_build_clients
from repro.fl.experiment import build_strategy as jax_build_strategy
from repro.fl.simulator import Simulator as JaxSimulator
from repro_torch.launch import quickstart
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

MAX_TIME = 600.0


@pytest.fixture(scope="module")
def runs():
    for k in [k for k in os.environ if k.startswith("REPRO_")]:  # the reference's knobs; the port takes none
        os.environ.pop(k)
    _, clients, init = jax_build_clients("har", num_clients=12, seed=0, latent_clusters=4)
    server = jax_build_strategy("echopfl", init, clients, seed=0)
    report = JaxSimulator(clients, server, eval_interval=120.0, target_acc=0.85, seed=0).run(max_time=MAX_TIME)
    init_np = [{k: np.asarray(v) for k, v in layer.items()} for layer in init]
    rnn_np = {k: np.asarray(v) for k, v in server._rnn_init.items()}
    port = quickstart.run("cpu", max_time=MAX_TIME, init_params=init_np, rnn_params=rnn_np, verbose=False)
    return (server, report), port


def test_ledgers_and_decisions_equal_the_references(runs):
    (js, jr), port = runs
    ts, tr = port["server"], port["report"]
    for name in ("up_events", "down_events", "up_bytes", "down_bytes", "duration"):
        assert getattr(tr, name) == getattr(jr, name), name
    assert tr.up_series == jr.up_series and tr.down_series == jr.down_series
    assert ts.events == js.events and {e["kind"] for e in ts.events} >= {"broadcast", "expand"}
    assert ts.clustering.assignment == js.clustering.assignment
    want = js.stats()
    got = ts.stats()
    assert {k: got[k] for k in want if k != "cluster_feedback_mean"} == \
        {k: want[k] for k in want if k != "cluster_feedback_mean"}
    assert sorted(got["cluster_feedback_mean"]) == sorted(want["cluster_feedback_mean"])
    np.testing.assert_allclose([got["cluster_feedback_mean"][c] for c in sorted(want["cluster_feedback_mean"])],
                               [want["cluster_feedback_mean"][c] for c in sorted(want["cluster_feedback_mean"])],
                               rtol=1e-4, atol=1e-6)


def test_accuracy_within_tolerance(runs):
    (_, jr), port = runs
    tr = port["report"]
    assert [t for t, _ in tr.curve] == [t for t, _ in jr.curve]
    np.testing.assert_allclose([a for _, a in tr.curve], [a for _, a in jr.curve], atol=0.01, rtol=0)
    assert abs(tr.final_acc - jr.final_acc) <= 0.01
    assert abs(port["acc"] - float(np.mean(list(jr.per_client_acc.values())))) <= 0.01
    assert port["acc"] > 0.5  # the quickstart's own bar


def test_cli_runs_on_the_cpu_and_refuses_a_missing_card(monkeypatch):
    """``--device`` reaches the run (stubbed here: the full 1,800 s is the
    test above's subject); the default asks for the card, which this host
    lacks, and raises rather than running on the CPU."""
    import torch

    seen = {}

    def fake_run(device, **kw):
        seen["device"] = device
        return {"acc": 0.9, "task": type("T", (), {"num_classes": 6})()}

    monkeypatch.setattr(quickstart, "run", fake_run)
    quickstart.main(["--device", "cpu"])
    assert seen["device"] == "cpu"
    monkeypatch.undo()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            quickstart.run("cuda", max_time=1.0, verbose=False)
