"""The broadcast predictor's chain (``core/broadcast.py::predictor_chain``)
on the CPU.

One chain walks one cluster's learn/decide steps of a coalesced window,
carrying the RNN weights and the last fired position on the device; labels
and fallback decisions are gathered from per-step tables by that position.
It is held to:

- the port's serial path (``_rnn_sgd``/``_rnn_want``, as
  ``BroadcastPredictor.learn``/``decide`` call them) with the table lookups
  replayed on the host: final weights bit for bit, identical wants, at
  ragged window lengths k and with learn-only, decide-only, fallback and
  idle steps;
- the reference's ``ops.predictor_chain`` given the same RNN weights
  (``init_rnn`` with ``jax.random``, handed over as numpy): identical wants,
  weights within rtol 1e-6 (atol 1e-7 for weights near zero).

It reads nothing back to the host while it runs.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.broadcast import init_rnn as jax_init_rnn
from repro.kernels import ops as jax_ops
from repro_torch.core.broadcast import BroadcastPredictor, _rnn_sgd, _rnn_want, build_seq, predictor_chain
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

LR = 1e-2


def _weights(seed):
    return {k: np.asarray(v) for k, v in jax_init_rnn(jax.random.PRNGKey(seed)).items()}


def _torch(params):
    return {k: torch.from_numpy(v.copy()) for k, v in params.items()}


def _window(k, steps, seed):
    """A chain's operands: record windows before/after each step's observe
    at length k, random gates (a fallback step decides from its table, not
    the RNN), and label/fallback tables whose columns differ, so the fired
    position matters."""
    rng = np.random.default_rng(seed * 101 + k)
    records = [float(x) for x in rng.uniform(0.1, 3.0, rng.integers(1, k + 1))]
    pre = np.zeros((steps, k, 1), np.float32)
    post = np.zeros((steps, k, 1), np.float32)
    for p in range(steps):
        pre[p] = build_seq(records, k)
        records = (records + [float(rng.uniform(0.1, 3.0))])[-k:]
        post[p] = build_seq(records, k)
    learn = rng.uniform(size=steps) < 0.7
    kind = rng.integers(0, 4, steps)  # 0 idle, 1 RNN decision, 2 fallback, 3 RNN decision
    decide, fallback = (kind == 1) | (kind == 3), kind == 2
    lab = rng.integers(0, 2, (steps, steps + 1)).astype(np.int64)
    fb = rng.uniform(size=(steps, steps + 1)) < 0.5
    return pre, post, lab, fb, learn, decide, fallback


def _serial(params, pre, post, lab, fb, learn, decide, fallback):
    """The serial path, the fired position tracked on the host."""
    fire, wants = 0, []
    for p in range(len(learn)):
        if learn[p]:
            params, _ = _rnn_sgd(params, torch.from_numpy(pre[p]), int(lab[p, fire]), LR)
        want = False
        if fallback[p]:
            want = bool(fb[p, fire])
        elif decide[p]:
            want = bool(_rnn_want(params, torch.from_numpy(post[p])))
        if want:
            fire = p + 1
        wants.append(want)
    return params, wants


def _same_bits(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k].view(torch.int32), b[k].view(torch.int32)) for k in a)


@pytest.mark.parametrize("k", [10, 12, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_chain_is_the_serial_path_bit_for_bit(k, seed):
    params = _torch(_weights(seed))
    args = _window(k, 9, seed)
    got, wants = predictor_chain(params, *args, LR)
    want_params, want = _serial(params, *args)
    assert wants.dtype == torch.bool and wants.tolist() == want
    assert _same_bits(got, want_params)


def test_one_step_chain_is_learn_then_decide():
    """A chain of one step against ``BroadcastPredictor.learn`` then
    ``decide`` themselves."""
    params = _torch(_weights(5))
    pred = BroadcastPredictor(params=params, k=10, records=[0.5, 1.25, 0.75])
    pre = build_seq(pred.records, 10)
    post = build_seq(pred.records + [2.0], 10)
    got, wants = predictor_chain(params, pre[None], post[None], np.ones((1, 2), np.int64),
                                     np.zeros((1, 2), bool), [True], [True], [False], LR)
    pred.learn(1)
    pred.observe(2.0)
    assert _same_bits(got, pred.params)
    assert bool(wants[0]) == pred.decide(accumulated_gap=0.0)


@pytest.mark.parametrize("gap", [0.0, 2.0])
@pytest.mark.parametrize("state", ["inactive", "fallback", "rnn"])
def test_planned_decision_is_decide(state, gap):
    """The coalesced planner's rules are the predictor's own: a shadow's
    ``decision_kind`` names the rule ``decide`` takes, and
    ``apply_decision`` with ``decide``'s outcome leaves the predictor as
    ``decide`` does. A shadow's records are its own."""
    records = {"inactive": [0.5, 1.0], "fallback": [0.5], "rnn": [0.5, 1.25, 0.75]}[state]
    a = BroadcastPredictor(params=_torch(_weights(3)), k=10, records=list(records), active=state != "inactive")
    b = a.shadow()
    assert b.shadow().decision_kind() == state and b.decisions == 0
    want = a.decide(accumulated_gap=gap)
    if state == "fallback":
        assert want == BroadcastPredictor.fallback_wants(gap, a.scale) == (gap > 1.0)
    assert b.apply_decision(want) == want
    assert (a.decisions, a.broadcasts, a.active, a.records) == (b.decisions, b.broadcasts, b.active, b.records)
    b.observe(3.0)
    assert a.records == records and b.records == records + [3.0]


def test_chain_reads_nothing_back_while_it_runs(monkeypatch):
    params = _torch(_weights(2))
    args = _window(12, 7, 3)

    def refuse(*a, **kw):
        raise AssertionError("predictor_chain read a tensor back to the host")

    for name in ("item", "tolist", "__bool__", "__int__", "__index__", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    predictor_chain(params, *args, LR)


@pytest.mark.parametrize("k", [10, 16])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chain_matches_the_reference(k, seed):
    w = _weights(seed)
    pre, post, lab, fb, learn, decide, fallback = _window(k, 8, seed + 10)
    got, wants = predictor_chain(_torch(w), pre, post, lab, fb, learn, decide, fallback, LR)
    r_params, r_wants = jax_ops.predictor_chain(
        {k_: jax.numpy.asarray(v) for k_, v in w.items()}, pre, post, lab.astype(np.int32), fb,
        learn, decide, fallback, 0, LR,
    )
    assert wants.tolist() == [bool(x) for x in np.asarray(r_wants)]
    for name, v in got.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(r_params[name]), rtol=1e-6, atol=1e-7, err_msg=name)
