"""The port's loop client backend (``client_backend="loop"``) against the
reference's loop backend and against the port's own fleet backend.

``har``, 8 clients, seed 0, the reference's initial MLP and pretrained RNN
handed over (torch cannot draw ``jax.random``), on the CPU: EchoPFL per
event and coalesced at 45 s, 900 s each (the reference takes its window
from ``REPRO_ASYNC_COALESCE``), FedAvg at 3 rounds, and ``tiny_lm`` FedAvg at 2
rounds. Port loop against reference loop: identical up/down events, bytes
and series, ``duration``, uploads or rounds, EchoPFL's event sequence,
assignment and staleness ledger; the accuracy curve and ``final_acc``
within 0.01. Port loop against port fleet: the same ledgers and decisions.
Also the feedback hook's rebinding and clearing when a strategy is reused,
and the backend's validation.
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.core.broadcast import pretrain_rnn as jax_pretrain_rnn
from repro.fl.experiment import build_clients as jax_build_clients
from repro.fl.experiment import run_experiment as jax_run_experiment
from repro.fl.lm_task import default_lm_task as jax_default_lm_task
from repro.fl.lm_task import run_lm_experiment as jax_run_lm_experiment
from repro_torch.core.broadcast import init_rnn
from repro_torch.fl.experiment import build_clients, build_strategy, run_experiment
from repro_torch.fl.lm_task import run_lm_experiment
from repro_torch.fl.simulator import Simulator
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

ARGS = dict(num_clients=8, seed=0)
CASES = {"echopfl": dict(max_time=900), "echopfl_45": dict(max_time=900, coalesce_window=45.0),
         "fedavg": dict(rounds=3)}
LEDGER = ("up_events", "down_events", "up_bytes", "down_bytes", "duration", "up_series", "down_series")


def _reference(name: str, kw: dict):
    kw = dict(kw)
    old = os.environ.get("REPRO_ASYNC_COALESCE")
    os.environ["REPRO_ASYNC_COALESCE"] = str(kw.pop("coalesce_window", 0.0))
    try:
        return jax_run_experiment("har", name.split("_")[0], client_backend="loop", **ARGS, **kw)
    finally:
        if old is None:
            os.environ.pop("REPRO_ASYNC_COALESCE")
        else:
            os.environ["REPRO_ASYNC_COALESCE"] = old


@pytest.fixture(scope="module")
def weights():
    _, _, init = jax_build_clients("har", ARGS["num_clients"], seed=ARGS["seed"])
    init_np = [{k: np.asarray(v) for k, v in layer.items()} for layer in init]
    rnn_np = {k: np.asarray(v) for k, v in jax_pretrain_rnn(jax.random.PRNGKey(ARGS["seed"])).items()}
    return init_np, rnn_np


@pytest.fixture(scope="module")
def runs(weights):
    init_np, rnn_np = weights
    out = {}
    for case, kw in CASES.items():
        name = case.split("_")[0]
        extra = dict(rnn_params=rnn_np) if name == "echopfl" else {}
        port = {b: run_experiment("har", name, device="cpu", init_params=init_np, client_backend=b,
                                  **ARGS, **kw, **extra) for b in ("loop", "fleet")}
        out[case] = (_reference(case, kw), port)
    return out


def _same_ledger(a, b) -> None:
    for field in LEDGER:
        assert getattr(a, field) == getattr(b, field), field
    key = "rounds" if "rounds" in a.extra else "uploads"
    assert a.extra[key] == b.extra[key]
    assert [t for t, _ in a.curve] == [t for t, _ in b.curve]


@pytest.mark.parametrize("case", list(CASES))
def test_port_loop_matches_the_reference_loop(runs, case):
    (_, _, js, jr), port = runs[case]
    _, _, ts, tr = port["loop"]
    _same_ledger(jr, tr)
    assert jr.summary()["total_MB"] == tr.summary()["total_MB"]
    if case.startswith("echopfl"):
        assert js.events == ts.events
        assert {e["kind"] for e in ts.events} >= {"broadcast", "expand"}
        assert js.clustering.assignment == ts.clustering.assignment
        assert js.staleness.snapshot() == ts.staleness.snapshot()
    else:
        assert js.stats() == ts.stats()
    np.testing.assert_allclose([a for _, a in tr.curve], [a for _, a in jr.curve], atol=0.01, rtol=0)
    assert abs(tr.final_acc - jr.final_acc) <= 0.01 and tr.final_acc > tr.curve[0][1]  # it learns


@pytest.mark.parametrize("case", list(CASES))
def test_port_loop_makes_the_fleets_decisions(runs, case):
    _, port = runs[case]
    (_, _, sl, rl), (_, _, sf, rf) = port["loop"], port["fleet"]
    _same_ledger(rl, rf)
    if case.startswith("echopfl"):
        assert sl.events == sf.events
        assert sl.clustering.assignment == sf.clustering.assignment
        assert sl.staleness.snapshot() == sf.staleness.snapshot()
    else:
        assert sl.stats() == sf.stats()
    np.testing.assert_allclose([a for _, a in rl.curve], [a for _, a in rf.curve], atol=1e-4, rtol=0)


def test_lm_loop_matches_the_reference_loop():
    jtask = jax_default_lm_task()
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    base_np, delta_np = to_np(jtask.base.params), to_np(jtask.init_params(jax.random.PRNGKey(0)))
    kw = dict(num_clients=4, seed=0, rounds=2)
    _, _, js, jr = jax_run_lm_experiment("fedavg", client_backend="loop", **kw)
    runs = {b: run_lm_experiment("fedavg", device="cpu", base_params=base_np, init_params=delta_np,
                                 client_backend=b, **kw) for b in ("loop", "fleet")}
    tr = runs["loop"][3]
    _same_ledger(jr, tr)
    _same_ledger(tr, runs["fleet"][3])
    np.testing.assert_allclose([a for _, a in tr.curve], [a for _, a in jr.curve], atol=0.01, rtol=0)
    np.testing.assert_allclose(runs["loop"][2]._vec.numpy(), np.asarray(js._vec), rtol=1e-4, atol=1e-6)


def test_fleet_hook_is_rebound_or_cleared_when_a_strategy_is_reused():
    _, clients, init = build_clients("har", 4, seed=0, samples_per_client=16, device="cpu")
    strat = build_strategy("echopfl", init, clients, seed=0, device="cpu",
                           rnn_params={k: v.numpy() for k, v in init_rnn(torch.Generator().manual_seed(0)).items()})
    sim_a = Simulator(clients, strat, client_backend="fleet", seed=0)
    sim_a._ensure_fleet(init)
    hook_a = strat.feedback_batch_fn
    assert getattr(hook_a, "_fleet_hook", False) and hook_a._fleet is sim_a._fleet
    sim_b = Simulator(clients, strat, client_backend="fleet", seed=0)
    sim_b._ensure_fleet(init)
    assert strat.feedback_batch_fn is not hook_a and strat.feedback_batch_fn._fleet is sim_b._fleet
    sim_c = Simulator(clients, strat, client_backend="loop", seed=0)
    sim_c._ensure_fleet(init)
    assert strat.feedback_batch_fn is None and sim_c._fleet is None  # probes go through feedback_fn
    sim_a._ensure_fleet(init)
    assert strat.feedback_batch_fn._fleet is sim_a._fleet
    own = lambda pairs: None  # noqa: E731  (a caller's own batch probe is left alone)
    strat.feedback_batch_fn = own
    sim_c._ensure_fleet(init)
    sim_b._ensure_fleet(init)
    assert strat.feedback_batch_fn is own


@pytest.mark.parametrize("backend", ["warp", ""])
def test_an_unknown_backend_raises(backend):
    _, clients, init = build_clients("har", 2, seed=0, samples_per_client=16, device="cpu")
    strat = build_strategy("fedavg", init, clients, seed=0, device="cpu")
    with pytest.raises(ValueError):
        Simulator(clients, strat, client_backend=backend)
