"""Compressed runs of the port end to end against the reference's, on the
CPU.

``har`` (6 clients, 900 s, seed 0): EchoPFL with ``uplink="topk"`` and
``"int8"``, per event and at a 45 s window; FedAsyn with both at 45 s;
FedAvg with ``"int8"`` for 4 rounds. ``tiny_lm`` (8 clients, 900 s):
EchoPFL with ``"topk"``. The reference takes its window from
``REPRO_ASYNC_COALESCE``; its ``REPRO_UPLINK*`` variables are unset and
``uplink=`` is passed to both. The port gets the reference's initial
weights and pretrained broadcast RNN. Identical: up/down bytes, events,
series and dense-equivalent bytes, ``duration``, ``summary()`` (with its
``uplink_ratio``), ``stats()`` (EchoPFL's mean chi2 feedback a cluster
within rtol 1e-5), the server's events, assignments and
staleness, and ``extra["uplink"]`` (payload bytes 3,640 for top-k and 4,586
for int8 at ``har``, and the launch count). Accuracy curves within 0.01.
Within the port: ``uplink=None`` and ``"none"`` are the run without the
argument bit for bit, and a 1e-9 s window is the per-event run bit for bit.
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
from repro_torch.fl.experiment import run_experiment
from repro_torch.fl.lm_task import run_lm_experiment
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

ARGS = dict(num_clients=6, seed=0)
CASES = [("echopfl", mode, w) for mode in ("topk", "int8") for w in (0.0, 45.0)] + [
    ("fedasyn", "topk", 45.0), ("fedasyn", "int8", 45.0), ("fedavg", "int8", 0.0)]
LEDGER = ("up_events", "down_events", "up_bytes", "down_bytes", "up_raw_bytes", "duration", "up_series",
          "down_series")
PAYLOAD = {"topk": 3640, "int8": 4586}  # har: 455 (index, value) pairs; 4,550 codes and 9 scales


@pytest.fixture(autouse=True)
def _no_uplink_env(monkeypatch):
    for name in ("REPRO_UPLINK", "REPRO_UPLINK_K", "REPRO_UPLINK_CHUNK"):
        monkeypatch.delenv(name, raising=False)


def _with_window(window: float, fn):
    old = os.environ.get("REPRO_ASYNC_COALESCE")
    os.environ["REPRO_ASYNC_COALESCE"] = str(window)
    try:
        return fn()
    finally:
        if old is None:
            os.environ.pop("REPRO_ASYNC_COALESCE")
        else:
            os.environ["REPRO_ASYNC_COALESCE"] = old


def _kw(name: str) -> dict:
    return dict(rounds=4) if name == "fedavg" else dict(max_time=900)


@pytest.fixture(scope="module")
def weights():
    _, _, init = jax_build_clients("har", ARGS["num_clients"], seed=ARGS["seed"])
    init_np = [{k: np.asarray(v) for k, v in layer.items()} for layer in init]
    rnn_np = {k: np.asarray(v) for k, v in jax_pretrain_rnn(jax.random.PRNGKey(ARGS["seed"])).items()}
    return init_np, rnn_np


def _port(name, mode, window, weights, **extra):
    init_np, rnn_np = weights
    kw = dict(rnn_params=rnn_np) if name == "echopfl" else {}
    return run_experiment("har", name, device="cpu", init_params=init_np, coalesce_window=window,
                          **ARGS, **_kw(name), **kw, **extra)


@pytest.fixture(scope="module")
def har_runs(weights):
    os.environ.pop("REPRO_UPLINK", None)
    out = {}
    for name, mode, window in CASES:
        ref = _with_window(window, lambda: jax_run_experiment("har", name, uplink=mode, **ARGS, **_kw(name)))
        out[name, mode, window] = (ref, _port(name, mode, window, weights, uplink=mode))
    return out


def _same_stats(want: dict, got: dict) -> None:
    """``stats()`` identical, but for EchoPFL's mean chi2 feedback a cluster
    (a float the two frameworks sum in another order): within rtol 1e-5."""
    want, got = dict(want), dict(got)
    fw, fg = want.pop("cluster_feedback_mean", {}), got.pop("cluster_feedback_mean", {})
    assert got == want and fw.keys() == fg.keys()
    np.testing.assert_allclose([fg[c] for c in fw], [fw[c] for c in fw], rtol=1e-5)


@pytest.mark.parametrize("name,mode,window", CASES)
def test_compressed_ledger_stats_and_decisions_are_identical(har_runs, name, mode, window):
    (_, _, js, jr), (_, _, ts, tr) = har_runs[name, mode, window]
    for field in LEDGER:
        assert getattr(jr, field) == getattr(tr, field), field
    assert tr.up_bytes == tr.up_events * PAYLOAD[mode] and tr.up_raw_bytes == tr.up_events * 4550 * 4
    assert jr.summary() == tr.summary() and "uplink_ratio" in tr.summary()
    _same_stats(js.stats(), ts.stats())
    assert tr.extra["uplink"] == jr.extra["uplink"]
    assert tr.extra["uplink"]["payload_bytes"] == PAYLOAD[mode] and tr.extra["uplink"]["mode"] == mode
    if name == "echopfl":
        assert js.events == ts.events and {e["kind"] for e in ts.events} >= {"broadcast"}
        assert js.clustering.assignment == ts.clustering.assignment
        assert js.staleness.snapshot() == ts.staleness.snapshot()
    if window:
        assert tr.extra["uplink"]["launches"] < tr.up_events  # a window's cohort is one encode
    elif name == "fedavg":
        assert tr.extra["uplink"]["launches"] == tr.extra["rounds"]  # one encode a cohort
    else:
        assert tr.extra["uplink"]["launches"] == tr.up_events


@pytest.mark.parametrize("name,mode,window", CASES)
def test_compressed_accuracy_tracks_the_reference(har_runs, name, mode, window):
    (_, _, _, jr), (_, _, _, tr) = har_runs[name, mode, window]
    assert [t for t, _ in jr.curve] == [t for t, _ in tr.curve]
    np.testing.assert_allclose([a for _, a in tr.curve], [a for _, a in jr.curve], atol=0.01, rtol=0)
    assert np.isfinite([a for _, a in tr.curve]).all()


def _bitwise(a, b):
    assert a.curve == b.curve and a.per_client_acc == b.per_client_acc
    for field in LEDGER:
        assert getattr(a, field) == getattr(b, field), field
    assert a.summary() == b.summary()


@pytest.mark.parametrize("name", ["echopfl", "fedavg"])
def test_no_codec_is_the_run_without_the_argument(weights, name):
    base = _port(name, None, 0.0, weights)[3]
    for spec in (None, "none"):
        rep = _port(name, None, 0.0, weights, uplink=spec)[3]
        _bitwise(base, rep)
        assert "uplink" not in rep.extra and rep.up_raw_bytes == rep.up_bytes
        assert "uplink_ratio" not in rep.summary()


@pytest.mark.parametrize("mode", ["topk", "int8"])
def test_compressed_tiny_window_is_the_per_event_run(har_runs, weights, mode):
    (_, _, se, re_) = har_runs["echopfl", mode, 0.0][1]
    _, _, sz, rz = _port("echopfl", mode, 1e-9, weights, uplink=mode)
    _bitwise(re_, rz)
    assert se.events == sz.events and se.clustering.assignment == sz.clustering.assignment
    for cid, c in se.clustering.clusters.items():
        assert np.array_equal(c.center_vec.numpy().view(np.uint32),
                              sz.clustering.clusters[cid].center_vec.numpy().view(np.uint32))


def test_lm_topk_run_matches_the_reference(monkeypatch):
    monkeypatch.delenv("REPRO_ASYNC_COALESCE", raising=False)
    kw = dict(num_clients=8, max_time=900, eval_interval=120, seed=0)
    jtask = jax_default_lm_task()
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    base_np, delta_np = to_np(jtask.base.params), to_np(jtask.init_params(jax.random.PRNGKey(0)))
    rnn_np = to_np(jax_pretrain_rnn(jax.random.PRNGKey(0)))
    _, _, js, jr = jax_run_lm_experiment("echopfl", uplink="topk", **kw)
    _, _, ts, tr = run_lm_experiment("echopfl", device="cpu", base_params=base_np, init_params=delta_np,
                                     rnn_params=rnn_np, uplink="topk", **kw)
    for field in LEDGER:
        assert getattr(jr, field) == getattr(tr, field), field
    assert tr.up_bytes == tr.up_events * 230 * 8 and tr.extra["uplink"] == jr.extra["uplink"]
    assert js.events == ts.events and js.clustering.assignment == ts.clustering.assignment
    _same_stats(js.stats(), ts.stats())
    assert [t for t, _ in jr.curve] == [t for t, _ in tr.curve]
    np.testing.assert_allclose([a for _, a in tr.curve], [a for _, a in jr.curve], atol=0.01, rtol=0)
