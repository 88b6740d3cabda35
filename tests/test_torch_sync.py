"""The port's synchronous loop and baselines end to end against the
reference's ``run_experiment`` and ``run_lm_experiment``.

``har``, 6 clients, seed 0: ``fedavg``, ``oort``, ``clusterfl`` and
``standalone`` at ``rounds=4``; ``fedasyn`` and ``fedsea`` at
``max_time=600``, per event and at a 45 s window (the reference takes its
window from ``REPRO_ASYNC_COALESCE``). The port gets the reference's
initial MLP (drawn with ``jax.random``, which torch cannot reproduce) and
runs on the CPU. Identical: up/down events and bytes and their series,
``duration``, rounds or uploads, ``stats()`` (versions, Oort's cohort
size, FedSEA's drops, FedAsyn's staleness ledger), ClusterFL's assignment,
``summary()`` and ``bytes_until``. The accuracy curve within 0.01 absolute;
the final global models within rtol 1e-4 / atol 1e-5 (local training sums
in another order in each framework). The port's FedAsyn coalesced is its
per-event run bit for bit. ``run_lm_experiment("fedavg", rounds=2)`` on
``tiny_lm`` (4 clients, the reference's base and delta handed over):
identical ledgers, curve within 0.01.
"""
import os

import jax
import numpy as np
import pytest

from repro.fl.experiment import build_clients as jax_build_clients
from repro.fl.experiment import run_experiment as jax_run_experiment
from repro.fl.lm_task import default_lm_task as jax_default_lm_task
from repro.fl.lm_task import run_lm_experiment as jax_run_lm_experiment
from repro_torch.common.pytrees import tree_flat_vector
from repro_torch.fl.experiment import run_experiment
from repro_torch.fl.lm_task import run_lm_experiment
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

ARGS = dict(num_clients=6, seed=0)
SYNC = ("fedavg", "oort", "clusterfl", "standalone")
CASES = [(name, 0.0) for name in SYNC] + [(name, w) for name in ("fedasyn", "fedsea") for w in (0.0, 45.0)]
LEDGER = ("up_events", "down_events", "up_bytes", "down_bytes", "duration", "up_series", "down_series", "extra")


def _reference(name: str, window: float):
    kw = dict(rounds=4) if name in SYNC else dict(max_time=600)
    old = os.environ.get("REPRO_ASYNC_COALESCE")
    os.environ["REPRO_ASYNC_COALESCE"] = str(window)
    try:
        return jax_run_experiment("har", name, **ARGS, **kw)
    finally:
        if old is None:
            os.environ.pop("REPRO_ASYNC_COALESCE")
        else:
            os.environ["REPRO_ASYNC_COALESCE"] = old


@pytest.fixture(scope="module")
def har_runs():
    _, _, init = jax_build_clients("har", ARGS["num_clients"], seed=ARGS["seed"])
    init_np = [{k: np.asarray(v) for k, v in layer.items()} for layer in init]
    out = {}
    for name, window in CASES:
        kw = dict(rounds=4) if name in SYNC else dict(max_time=600, coalesce_window=window)
        port = run_experiment("har", name, device="cpu", init_params=init_np, **ARGS, **kw)
        out[name, window] = (_reference(name, window), port)
    return out


def _global(strat) -> np.ndarray:
    vec = getattr(strat, "_vec", None)
    if vec is None:
        vec = tree_flat_vector(strat.global_model) if hasattr(strat, "global_model") else None
    return None if vec is None else np.asarray(vec)


@pytest.mark.parametrize("name,window", CASES)
def test_ledger_stats_and_summary_are_identical(har_runs, name, window):
    (_, _, js, jr), (_, _, ts, tr) = har_runs[name, window]
    for field in LEDGER:
        assert getattr(jr, field) == getattr(tr, field), field
    assert js.stats() == ts.stats()
    assert jr.summary() == tr.summary()
    t = jr.time_to_target if jr.time_to_target is not None else jr.duration
    assert jr.bytes_until(t) == tr.bytes_until(t) and tr.bytes_until(t)[0] > 0
    assert jr.per_client_class == tr.per_client_class
    key = "rounds" if name in SYNC else "uploads"
    assert tr.extra[key] >= (4 if name in SYNC else 30)


@pytest.mark.parametrize("name,window", CASES)
def test_accuracy_curve_and_global_model_track_the_reference(har_runs, name, window):
    (_, _, js, jr), (_, _, ts, tr) = har_runs[name, window]
    assert [t for t, _ in jr.curve] == [t for t, _ in tr.curve]
    np.testing.assert_allclose([a for _, a in tr.curve], [a for _, a in jr.curve], atol=0.01, rtol=0)
    assert tr.per_client_acc.keys() == jr.per_client_acc.keys()
    want, got = _global(js), _global(ts)
    if want is not None:
        assert got.shape == want.shape == (4550,)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_clusterfl_assignment_is_identical(har_runs):
    (_, _, js, _), (_, _, ts, _) = har_runs["clusterfl", 0.0]
    assert ts.assignment == js.assignment and len(set(ts.assignment.values())) > 1
    assert ts.versions == js.versions
    ids = sorted(ts.assignment)
    np.testing.assert_array_equal(ts.membership_matrix(ids), js.membership_matrix(ids))


@pytest.mark.parametrize("name", ["fedasyn", "fedsea"])
def test_coalesced_run_is_the_per_event_run_bit_for_bit(har_runs, name):
    (_, (_, _, se, re_)), (_, (_, _, sc, rc)) = har_runs[name, 0.0], har_runs[name, 45.0]
    a, b = _global(se), _global(sc)
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    assert re_.curve == rc.curve and se.stats() == sc.stats()


def test_lm_fedavg_matches_the_reference():
    jtask = jax_default_lm_task()
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    base_np = to_np(jtask.base.params)
    delta_np = to_np(jtask.init_params(jax.random.PRNGKey(0)))
    kw = dict(num_clients=4, seed=0, rounds=2)
    _, _, js, jr = jax_run_lm_experiment("fedavg", **kw)
    _, _, ts, tr = run_lm_experiment("fedavg", device="cpu", base_params=base_np, init_params=delta_np, **kw)
    for field in LEDGER:
        assert getattr(jr, field) == getattr(tr, field), field
    assert tr.extra["rounds"] == 2 and tr.up_bytes == tr.up_events * 2304 * 4  # billed at delta size
    assert [t for t, _ in jr.curve] == [t for t, _ in tr.curve]
    np.testing.assert_allclose([a for _, a in tr.curve], [a for _, a in jr.curve], atol=0.01, rtol=0)
    np.testing.assert_allclose(ts._vec.numpy(), np.asarray(js._vec), rtol=1e-4, atol=1e-6)
