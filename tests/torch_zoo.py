"""Shared checks of the model zoo's reduced archs, the port against the
reference, on the CPU (``test_torch_zoo_attention.py`` and
``test_torch_zoo_recurrent.py`` run them for their archs).

Every arch is cut by ``reduced_config`` (d_model 64, 2 periods, at most 4
heads, vocab <= 512, 4 experts top 2, MLA ranks 16/8/8/8, Mamba d_state 8)
and runs on the reference's weights (``init_params(cfg, PRNGKey(0))``),
handed over as numpy. The reference's step functions are jitted once per
arch and variant and cached: its eager forward takes seconds a call here.

Tolerances. Logits within rtol 1e-4, atol 1e-4 of the reference's, except
where ``SENSITIVE`` says otherwise; states, caches and the MoE aux loss
within the same. A model is held to 1e-4 only where fp32 rounding allows
it: ``conditioning`` measures how far the reference's own logits move when
its embeddings are perturbed by one ulp (``_perturbed``: relative 6e-8,
a random sign an element). Reduced xLSTM's move 3.3e-4 there (16 blocks of exponential
gating, each amplifying what reaches it), so a port that rounds any
product differently cannot come closer end to end; its full-model
comparisons take 1e-3 (3 times that spread), and every one of its layers
is held to 1e-5 on the reference's own input (``check_layers``). The
train steps: losses within rtol 1e-5, params by ``check_train``'s counts.
Reduced xLSTM's reference, trained from weights one ulp away, is 0.08 away
in loss by its third step; its train steps are held to 3 times that spread
of the reference's own.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCH_REGISTRY as JAX_ARCHS
from repro.configs.base import reduced_config as jax_reduced
from repro.models import model as jax_model
from repro.models.steps import TrainState as JaxTrainState
from repro.models.steps import cross_entropy as jax_cross_entropy
from repro.models.steps import make_optimizer as jax_make_optimizer
from repro.models.steps import make_serve_step as jax_serve_step
from repro.models.steps import make_train_step as jax_train_step
from repro_torch.common.pytrees import tree_leaves, tree_map, tree_unflatten
from repro_torch.configs import get_config, reduced_config
from repro_torch.interop import tree_from_numpy
from repro_torch.launch.serve import decode, prefill
from repro_torch.models import model as port_model
from repro_torch.models.steps import (TrainState, make_eval_step, make_optimizer, make_prefill_step,
                                      make_serve_step, make_train_step)

ATOL = 1e-4
B, S, GEN = 2, 12, 8
# full-model logit tolerance of the archs whose reference moves more than 1e-4 under one ulp of input noise:
# 3 x that spread (``conditioning``), measured 3.3e-4 for reduced xLSTM
SENSITIVE = {"xlstm-1.3b": 1e-3}


def tol(name: str) -> float:
    return SENSITIVE.get(name, ATOL)


def _replace(cfg, **change):
    return dataclasses.replace(cfg, **change) if change else cfg


@functools.lru_cache(maxsize=None)
def weights(name: str):
    """The reduced configs and the reference's weights (jax and torch); shared, never written."""
    jcfg = jax_reduced(JAX_ARCHS[name])
    jp = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, reduced_config(get_config(name)), jp, tree_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


def configs(name: str, dropless: bool = False):
    jcfg, tcfg, jp, tp = weights(name)
    return _replace(jcfg, moe_dropless=True) if dropless else jcfg, \
        _replace(tcfg, moe_dropless=True) if dropless else tcfg, jp, tp


def batch(cfg, shape=(B, S), seed=1) -> dict:
    """Tokens, or frame embeddings for an encoder (numpy)."""
    rng = np.random.default_rng(seed)
    if cfg.is_encoder:
        return {"embeds": rng.standard_normal((*shape, cfg.d_model)).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, shape)}


def as_jax(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def as_torch(b: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def jax_forward(name: str, dropless: bool = False):
    """The reference's jitted full forward with its prefill caches:
    ``(logits, aux, cache)``."""
    jcfg = configs(name, dropless)[0]
    return jax.jit(lambda p, b: jax_model.forward(jcfg, p, b, return_cache=True))


@functools.lru_cache(maxsize=None)
def reference_run(name: str, dropless: bool = False):
    """The reference's forward on ``batch`` (cached numpy)."""
    jcfg, tcfg, jp, _ = configs(name, dropless)
    logits, aux, cache = jax_forward(name, dropless)(jp, as_jax(batch(tcfg)))
    return np.asarray(logits), float(aux), jax.tree_util.tree_map(np.asarray, cache)


def close(got, want, tolerance, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tolerance, atol=tolerance, err_msg=msg)


def _perturbed(jp):
    """The reference's weights with the embedding scaled by ``1 +- 6e-8``
    (a random sign an element): one ulp of noise."""
    sign = np.random.default_rng(5).choice([-1.0, 1.0], jp["embed"].shape)
    return dict(jp, embed=jp["embed"] * (1 + 6e-8 * sign).astype(np.float32))


def conditioning(name: str) -> float:
    """How far the reference's logits move from ``_perturbed`` weights: the
    spread fp32 rounding alone can cause."""
    _, tcfg, jp, _ = weights(name)
    moved = jax_forward(name)(_perturbed(jp), as_jax(batch(tcfg)))[0]
    return float(np.abs(np.asarray(moved) - reference_run(name)[0]).max())


# ------------------------------------------------------------------ checks
def check_forward(name: str):
    """Full-forward logits and the summed MoE aux loss; ``last=1`` against
    the full projection's last row."""
    _, tcfg, _, tp = weights(name)
    want, want_aux, _ = reference_run(name)
    logits, aux, cache = port_model.forward(tcfg, tp, as_torch(batch(tcfg)))
    assert cache is None
    close(logits, want, tol(name), "logits")
    close(aux, want_aux, ATOL, "aux")
    assert (want_aux > 0) == (tcfg.moe is not None)
    last = port_model.forward(tcfg, tp, as_torch(batch(tcfg)), last=1)[0]
    np.testing.assert_allclose(last.numpy(), logits[:, -1:].numpy(), rtol=1e-5, atol=1e-5)


def check_layers(name: str):
    """Every layer (prefix, then each period's slots) on the reference's
    own input to it, within 1e-5: the port's local error, before the model
    amplifies it."""
    jcfg, tcfg, jp, tp = weights(name)
    b = batch(tcfg)
    if "tokens" in b:
        x = jnp.take(jp["embed"], jnp.asarray(b["tokens"]), axis=0)
    else:
        x = jnp.asarray(b["embeds"]) + jax_model._sinusoidal(S, jcfg.d_model, jnp.float32)[None]
    layers = [(jp["prefix"][i], tp["prefix"][i], spec) for i, spec in enumerate(jcfg.prefix)]
    for p in range(jcfg.num_periods):
        for i, spec in enumerate(jcfg.pattern):
            slot = f"slot{i}"
            layers.append((jax.tree_util.tree_map(lambda t: t[p], jp["blocks"][slot]),
                           tree_map(lambda t: t[p], tp["blocks"][slot]), spec))
    apply = jax.jit(lambda spec, lp, xx: jax_model._apply_layer(lp, spec, jcfg, xx, cache=None, pos0=0,
                                                                decode=False)[0], static_argnums=0)
    for n, (jl, tl, spec) in enumerate(layers):
        got = port_model._apply_layer(tl, spec, tcfg, torch.from_numpy(np.array(x)), cache=None, pos0=0,
                                      decode=False, collect=False)[0]
        x = apply(spec, jl, x)
        close(got, x, 1e-5, f"layer {n} ({spec})")


def check_layer_grads(name: str):
    """Every layer's gradients (its params and its input) of ``sum(out *
    w)``, ``w`` fixed and random, on the reference's own input to it,
    within rtol/atol 1e-4 of the reference's (jitted once a layer kind):
    the backward's local error (gradients up to about 5 here, summed over
    the batch and the sequence)."""
    jcfg, tcfg, jp, tp = weights(name)
    x = jnp.take(jp["embed"], jnp.asarray(batch(tcfg)["tokens"]), axis=0)
    w = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    @functools.partial(jax.jit, static_argnums=0)
    def jgrads(spec, lp, xx):
        def f(p, y):
            return jnp.sum(jax_model._apply_layer(p, spec, jcfg, y, cache=None, pos0=0, decode=False)[0] * w)
        return jax.grad(f, argnums=(0, 1))(lp, xx), jax_model._apply_layer(lp, spec, jcfg, xx, cache=None, pos0=0,
                                                                           decode=False)[0]

    for p in range(jcfg.num_periods):
        for i, spec in enumerate(jcfg.pattern):
            jl = jax.tree_util.tree_map(lambda t: t[p], jp["blocks"][f"slot{i}"])
            tl = tree_map(lambda t: t[p], tp["blocks"][f"slot{i}"])
            (jg, jgx), x_next = jgrads(spec, jl, x)
            leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tl)]
            xt = torch.from_numpy(np.array(x)).requires_grad_(True)
            out = port_model._apply_layer(tree_unflatten(tl, leaves), spec, tcfg, xt, cache=None, pos0=0,
                                          decode=False, collect=False)[0]
            grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), [*leaves, xt])
            for a, b in zip(grads, [*jax.tree_util.tree_leaves(jg), jgx]):
                close(a, b, 1e-4, f"period {p} slot {i} ({spec})")
            x = x_next


def check_prefill(name: str):
    """The prefill step's last-position logits and exact-length caches;
    ``init_cache``'s shapes and ``len``; the caches grafted into it."""
    jcfg, tcfg, _, tp = weights(name)
    want, _, jcache = reference_run(name)
    logits, cache = make_prefill_step(tcfg)(tp, as_torch(batch(tcfg)))
    close(logits, want[:, -1:], tol(name), "prefill logits")
    assert cache["len"] == int(jcache["len"]) == S
    got_leaves, want_leaves = tree_leaves({k: v for k, v in cache.items() if k != "len"}), \
        jax.tree_util.tree_leaves({k: v for k, v in jcache.items() if k != "len"})
    assert len(got_leaves) == len(want_leaves) > 0
    for a, w in zip(got_leaves, want_leaves):
        assert tuple(a.shape) == w.shape
        close(a, w, tol(name), "cache")
    fixed = port_model.init_cache(tcfg, B, ctx_len=S, margin=GEN + 8)
    jfixed = jax_model.init_cache(jcfg, B, ctx_len=S, margin=GEN + 8)
    assert fixed["len"] == int(jfixed["len"]) == S
    pairs = list(zip(tree_leaves({k: v for k, v in fixed.items() if k != "len"}),
                     jax.tree_util.tree_leaves({k: v for k, v in jfixed.items() if k != "len"})))
    assert len(pairs) == len(want_leaves)
    for a, w in pairs:
        assert tuple(a.shape) == w.shape and a.dtype == torch.float32
        assert np.array_equal(a.numpy(), np.asarray(w))  # zeros, mLSTM's m at -1e30, sLSTM's n at 1e-6
    grafted = tree_map(port_model.graft, fixed, cache)
    for a, pre in zip(tree_leaves({k: v for k, v in grafted.items() if k != "len"}), got_leaves):
        if a.shape == pre.shape:
            assert torch.equal(a, pre)
        else:  # a sequence axis: the prefill's S slots, then zeros
            axis = next(i for i, (m, n) in enumerate(zip(a.shape, pre.shape)) if m != n)
            assert torch.equal(a.narrow(axis, 0, S), pre) and not a.narrow(axis, S, a.shape[axis] - S).any()


def _jax_graft(fixed, pre):
    if fixed.shape == pre.shape:
        return pre
    axis = next(i for i, (a, b) in enumerate(zip(fixed.shape, pre.shape)) if a != b)
    pad = [(0, 0)] * fixed.ndim
    pad[axis] = (0, fixed.shape[axis] - pre.shape[axis])
    return jnp.pad(pre, pad)


@functools.lru_cache(maxsize=None)
def jax_serve(name: str, dropless: bool):
    return jax.jit(jax_serve_step(configs(name, dropless)[0]))


def check_decode_against_reference(name: str, dropless: bool):
    """8 decode steps after the prefill, the same tokens fed to both, each
    step's logits against the reference's jitted serve step."""
    jcfg, tcfg, jp, tp = configs(name, dropless)
    b = batch(tcfg)
    _, _, jpre = jax_forward(name, dropless)(jp, as_jax(b))
    jcache = jax.tree_util.tree_map(_jax_graft, jax_model.init_cache(jcfg, B, ctx_len=S, margin=GEN + 8), jpre)
    serve = jax_serve(name, dropless)
    _, tcache = prefill(tcfg, tp, torch.from_numpy(b["tokens"]), GEN)
    feed = np.random.default_rng(5).integers(0, tcfg.vocab_size, (B, GEN))
    tserve = make_serve_step(tcfg)
    for i in range(GEN):
        jl, jcache = serve(jp, jcache, {"tokens": jnp.asarray(feed[:, i:i + 1])})
        tl, tcache = tserve(tp, tcache, {"tokens": torch.from_numpy(feed[:, i:i + 1])})
        close(tl, jl, tol(name), f"step {i}")
    assert tcache["len"] == int(jcache["len"]) == S + GEN
    for a, w in zip(tree_leaves({k: v for k, v in tcache.items() if k != "len"}),
                    jax.tree_util.tree_leaves({k: v for k, v in jcache.items() if k != "len"})):
        close(a, w, tol(name), "cache after the steps")


def check_decode_against_forward(name: str):
    """Greedy decode (MoE dropless, so that no token is dropped at either
    length) against the port's own teacher-forced full forward."""
    _, tcfg, _, tp = configs(name, dropless=True)
    prompts = torch.from_numpy(batch(tcfg)["tokens"])
    logits, cache = prefill(tcfg, tp, prompts, GEN)
    toks, steps = decode(tcfg, tp, cache, logits, GEN, keep_logits=True)
    full = port_model.forward(tcfg, tp, {"tokens": torch.cat([prompts, toks], dim=1)})[0]
    close(logits[:, 0], full[:, S - 1], tol(name), "prefill")
    for i, step in enumerate(steps):
        close(step, full[:, S + i], tol(name), f"step {i}")


@functools.lru_cache(maxsize=None)
def train_runs(name: str):
    """Both packages' train states and every step's metrics after 1 and 8
    steps on the same batches (a few labels masked as padding); for a
    ``SENSITIVE`` arch also the reference's run from ``_perturbed``
    weights."""
    jcfg, tcfg, jp, tp = weights(name)
    jstep, tstep = jax.jit(jax_train_step(jcfg)), make_train_step(tcfg)
    jopt, topt = jax_make_optimizer(jcfg), make_optimizer(tcfg)
    js = JaxTrainState(jp, jopt.init(jp), jnp.zeros((), jnp.int32))
    ts = TrainState(tp, topt.init(tp), torch.zeros((), dtype=torch.int32))
    moved = JaxTrainState(_perturbed(jp), jopt.init(jp), jnp.zeros((), jnp.int32)) if name in SENSITIVE else None
    out, metrics = {}, []
    for i in range(8):
        rng = np.random.default_rng(10 + i)
        labels = rng.integers(0, tcfg.vocab_size, (4, S))
        labels[0, :3] = tcfg.vocab_size  # masked pad labels
        b = dict(batch(tcfg, (4, S), seed=20 + i), labels=labels)
        js, jm = jstep(js, as_jax(b))
        ts, tm = tstep(ts, b)
        mm = None
        if moved is not None:
            moved, mm = jstep(moved, as_jax(b))
        metrics.append((jm, tm, mm))
        if i + 1 in (1, 8):
            out[i + 1] = (js, ts, moved, list(metrics))
    return out


def _params_off(a_tree, b_tree, lr: float) -> tuple[int, int, int, float]:
    """Elements of ``a`` beyond atol 1e-6 of ``b``, beyond atol 0.1 lr (both
    with rtol 1e-4), the element count and the largest difference."""
    off = big = total = 0
    worst = 0.0
    for a, b in zip(a_tree, b_tree):
        a, b = np.asarray(a), np.asarray(b)
        d, r = np.abs(a - b), 1e-4 * np.abs(b)
        off += int((d > 1e-6 + r).sum())
        big += int((d > 0.1 * lr + r).sum())
        total += a.size
        worst = max(worst, float(d.max()))
    return off, big, total, worst


def check_train(name: str, steps: int):
    """Each step's loss, ce and MoE aux and the params after ``steps``. The
    params: at most 0.1% of the elements beyond atol 1e-6 and at most
    0.001% beyond atol 0.1 lr (rtol 1e-4 in both): Adam's and Adafactor's
    first updates divide each gradient by its own magnitude, so an element
    whose gradient is at the level of rounding noise steps by about the
    learning rate either way; none beyond 2.5 lr a step. A ``SENSITIVE``
    arch is held to 3 times the reference's distance from its own run on
    ``_perturbed`` weights instead (both counts, and the losses to 3 times
    the largest distance up to that step: a chaotic run's spread does not
    shrink), and to the same 2.5 lr a step."""
    _, tcfg, _, _ = weights(name)
    js, ts, moved, metrics = train_runs(name)[steps]
    lr = tcfg.train.learning_rate
    spread = {"loss": 0.0, "ce": 0.0, "moe_aux": 0.0}  # the reference's own, the largest so far
    for i, (jm, tm, mm) in enumerate(metrics):
        for k in ("loss", "ce", "moe_aux"):
            want = float(jm[k])
            if mm is not None:
                spread[k] = max(spread[k], abs(float(mm[k]) - want))
            limit = max(1e-5 * abs(want), 1e-6 if k == "moe_aux" else 0.0, 3 * spread[k])
            assert abs(float(tm[k]) - want) <= limit, (k, i, float(tm[k]), want, limit)
    assert int(tm["step"]) == int(jm["step"]) == steps
    off, big, total, worst = _params_off(tree_leaves(ts.params), jax.tree_util.tree_leaves(js.params), lr)
    off_limit, big_limit = 1e-3 * total, 1e-5 * total
    if moved is not None:
        m_off, m_big, _, _ = _params_off(jax.tree_util.tree_leaves(moved.params),
                                         jax.tree_util.tree_leaves(js.params), lr)
        off_limit, big_limit = max(off_limit, 3 * m_off), max(big_limit, 3 * m_big)
    assert off <= off_limit and big <= big_limit, (off, off_limit, big, big_limit, total)
    assert worst <= 2.5 * lr * steps, (worst, lr)
    assert not any(t.requires_grad for t in tree_leaves(ts.params))


def check_eval(name: str):
    """The eval step's cross entropy and accuracy against the reference's
    ``cross_entropy`` and argmax on its forward logits."""
    _, tcfg, _, tp = weights(name)
    want = reference_run(name)[0]
    labels = np.random.default_rng(7).integers(0, tcfg.vocab_size, (B, S))
    got = make_eval_step(tcfg)(tp, dict(batch(tcfg), labels=labels))
    ce = float(jax_cross_entropy(jnp.asarray(want), jnp.asarray(labels), tcfg.vocab_size))
    np.testing.assert_allclose(float(got["ce"]), ce, rtol=1e-5 if name not in SENSITIVE else 1e-4)
    assert float(got["accuracy"]) == float(np.mean(np.argmax(want, -1) == labels))
