"""Shared checks of training on the CPU, the port against the reference
(``test_torch_train.py`` runs them for reduced llama3.2-1b,
``test_torch_train_zoo.py`` for the reduced MoE and Mamba archs).

* **The driver.** The reference's ``repro.launch.train`` fails on jax 0.9.0
  (``ShardingTypeError`` on its one-device mesh), so its loop body is
  replayed without a mesh (``reference_loop``): ``init_params(PRNGKey(0))``
  (``torch_zoo.weights``), ``make_optimizer``, the jitted
  ``make_train_step``, ``token_stream(seed=0)`` and its ``Checkpointer``
  (every ``ckpt_every`` steps, the newest restored at the start, the stream
  drawn from its start again). The port's ``launch.train.train`` runs on
  the reference's weights (``port_train``); batch 2, 16 tokens.
  ``check_against_reference``: each loss within rtol 1e-5; the params by
  ``tests/test_torch_models.py``'s rule for a dense arch (every element
  within rtol 1e-4, atol 0.1 lr, at most 0.1% beyond atol 1e-6) and by
  ``tests/torch_zoo.py``'s ``check_train`` counts for an MoE arch (at most
  0.001% beyond atol 0.1 lr, none beyond 2.5 lr a step: its routing jumps
  at near-ties).
* **Remat.** ``check_remat``: ``cfg.train.remat`` on and off give the same
  bits over 2 train steps (loss, metrics, every param and optimizer leaf),
  and with it on a train step runs every period's layers twice (the prefix
  once). ``check_eval_and_prefill``: eval and prefill run each layer once
  under remat, with the bits they give without it.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_zoo
from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from repro.data.lm import token_stream as jax_token_stream
from repro.models.steps import TrainState as JaxTrainState
from repro.models.steps import make_optimizer as jax_make_optimizer
from repro.models.steps import make_train_step as jax_train_step
from repro_torch.common.pytrees import tree_leaves
from repro_torch.data.lm import token_stream
from repro_torch.launch import train as driver
from repro_torch.models import model as port_model
from repro_torch.models.steps import TrainState, make_eval_step, make_optimizer, make_prefill_step, make_train_step

BATCH, SEQ = 2, 16


# ------------------------------------------------------------------ the driver
@functools.lru_cache(maxsize=None)
def _jax_step(name: str):
    jcfg = torch_zoo.weights(name)[0]
    return jax.jit(jax_train_step(jcfg, jax_make_optimizer(jcfg)))


def reference_loop(name: str, steps: int, ckpt_dir: str | None = None, ckpt_every: int = 50,
                   keep_at: tuple = ()) -> dict:
    """``repro.launch.train``'s loop on one device without a mesh: its
    state, optimizer, stream and checkpointer; the states after the
    steps in ``keep_at`` and each step's loss."""
    jcfg, _, jp, _ = torch_zoo.weights(name)
    opt = jax_make_optimizer(jcfg)
    state = JaxTrainState(jp, opt.init(jp), jnp.zeros((), jnp.int32))
    step_fn = _jax_step(name)
    ck = JaxCheckpointer(ckpt_dir, keep=3) if ckpt_dir else None
    start = 0
    if ck is not None:
        got = ck.restore_latest(like=jax.tree_util.tree_map(np.asarray, state))
        if got is not None:
            start, restored, _ = got
            state = jax.device_put(restored)
    stream = jax_token_stream(jcfg.vocab_size, seed=0, batch=BATCH, seq=SEQ)
    losses, kept = [], {}
    for i in range(start, steps):
        state, metrics = step_fn(state, next(stream))
        losses.append(float(metrics["loss"]))
        if i + 1 in keep_at:
            kept[i + 1] = state
        if ck is not None and (i + 1) % ckpt_every == 0:
            ck.save_async(i + 1, state, extra={"loss": float(metrics["loss"])})
    if ck is not None:
        ck.wait()
        ck.close()
    return {"state": state, "start": start, "losses": losses, "kept": kept}


@functools.lru_cache(maxsize=None)
def reference_run(name: str) -> dict:
    """The reference's loop over 8 steps, its states after 1 and 8 kept."""
    return reference_loop(name, 8, keep_at=(1, 8))


def port_train(name: str, steps: int, **kw) -> dict:
    _, tcfg, _, tp = torch_zoo.weights(name)
    return driver.train(tcfg, steps=steps, batch=BATCH, seq=SEQ, device="cpu", params=tp, verbose=False, **kw)


def check_against_reference(name: str, got: dict, want_state, want_losses: list) -> None:
    lr = torch_zoo.weights(name)[1].train.learning_rate
    moe = torch_zoo.weights(name)[1].moe is not None
    assert len(got["losses"]) == len(want_losses)
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
    assert int(got["state"].step) == int(want_state.step)
    a_leaves, b_leaves = tree_leaves(got["state"].params), jax.tree_util.tree_leaves(want_state.params)
    off, big, total, worst = torch_zoo._params_off(a_leaves, b_leaves, lr)
    assert off <= 1e-3 * total, (off, total)
    if moe:
        assert big <= 1e-5 * total and worst <= 2.5 * lr * len(want_losses), (big, worst, total)
    else:
        assert big == 0, (big, worst)
    assert not any(t.requires_grad for t in tree_leaves(got["state"]))


def check_driver(name: str, steps: int) -> None:
    want = reference_run(name)
    got = port_train(name, steps)
    assert got["start"] == 0 and len(got["step_s"]) == steps and got["tokens_per_s"] > 0
    check_against_reference(name, got, want["kept"][steps], want["losses"][:steps])


# ------------------------------------------------------------------ remat
def with_remat(cfg, remat: bool):
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, remat=remat))


def _layer_calls(monkeypatch) -> list:
    """Count ``models.model._apply_layer_shards`` calls (one a layer a
    forward)."""
    calls = []
    apply_layer = port_model._apply_layer_shards

    def counted(*a, **kw):
        calls.append(1)
        return apply_layer(*a, **kw)

    monkeypatch.setattr(port_model, "_apply_layer_shards", counted)
    return calls


def _stream(cfg):
    return token_stream(cfg.vocab_size, seed=0, batch=BATCH, seq=SEQ)


def _num_layers(cfg) -> int:
    return len(cfg.prefix) + cfg.num_periods * len(cfg.pattern)


def check_remat(name: str, monkeypatch) -> None:
    _, tcfg, _, tp = torch_zoo.weights(name)
    assert tcfg.train.remat
    recomputed = tcfg.num_periods * len(tcfg.pattern)  # the prefix is not wrapped
    runs = {}
    for remat in (True, False):
        cfg = with_remat(tcfg, remat)
        opt = make_optimizer(cfg)
        state = TrainState(tp, opt.init(tp), torch.zeros((), dtype=torch.int32))
        step = make_train_step(cfg, opt)
        stream = _stream(cfg)
        calls = _layer_calls(monkeypatch)
        metrics = []
        for _ in range(2):
            state, m = step(state, next(stream))
            metrics.append(m)
        monkeypatch.undo()
        assert len(calls) == 2 * (_num_layers(tcfg) + (recomputed if remat else 0)), (remat, len(calls))
        runs[remat] = (state, metrics)
    (a, ma), (b, mb) = runs[True], runs[False]
    for x, y in zip(ma, mb):
        assert sorted(x) == sorted(y) and all(torch.equal(x[k], y[k]) for k in x)
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def check_eval_and_prefill(name: str, monkeypatch) -> None:
    _, tcfg, _, tp = torch_zoo.weights(name)
    n_layers = _num_layers(tcfg)
    batch = next(_stream(tcfg))
    calls = _layer_calls(monkeypatch)
    ev = make_eval_step(tcfg)(tp, batch)
    assert len(calls) == n_layers
    logits, _ = make_prefill_step(tcfg)(tp, {"tokens": batch["tokens"]})
    assert len(calls) == 2 * n_layers
    monkeypatch.undo()
    off = make_eval_step(with_remat(tcfg, False))(tp, batch)
    assert all(torch.equal(ev[k], off[k]) for k in ev)
    assert torch.equal(logits, make_prefill_step(with_remat(tcfg, False))(tp, {"tokens": batch["tokens"]})[0])
