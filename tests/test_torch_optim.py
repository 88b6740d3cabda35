"""The port's optimizers and schedules against the reference's, on the CPU.

Seeded params and 10 steps of seeded gradients (numpy) go through each
optimizer of both packages: ``sgd``, ``momentum`` (with and without
Nesterov), ``adam``, ``adamw`` and ``adafactor`` (a (256, 130) leaf,
factored; a (3, 4) and a (7,) leaf, not), each under a constant learning
rate and the two decaying schedules. Params, updates and every state leaf
(the NamedTuple's leaves in the reference's order) agree within rtol 1e-5,
atol 1e-7 (fp32 rounding of the same ops). ``clip_by_global_norm`` below
and above its threshold, and the schedules alone over 40 steps, agree
within the same tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adafactor as jax_adafactor_mod
from repro.optim import optimizers as J
from repro.optim import schedules as JS
from repro_torch.common.pytrees import tree_leaves
from repro_torch.interop import tree_from_numpy
from repro_torch.optim import adafactor as port_adafactor_mod
from repro_torch.optim import optimizers as T
from repro_torch.optim import schedules as TS
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

RTOL, ATOL = 1e-5, 1e-7
SHAPES = {"big": (256, 130), "small": (3, 4), "bias": (7,)}

OPTIMIZERS = {
    "sgd": (J.sgd, T.sgd, {}),
    "momentum": (J.momentum, T.momentum, {}),
    "nesterov": (J.momentum, T.momentum, {"nesterov": True}),
    "adam": (J.adam, T.adam, {}),
    "adamw": (J.adamw, T.adamw, {}),
    "adafactor": (jax_adafactor_mod.adafactor, port_adafactor_mod.adafactor, {}),
}
SCHEDULES = {
    "constant": (lambda: 0.05, lambda: 0.05),
    "cosine_decay": (lambda: JS.cosine_decay(0.05, 8, alpha=0.1), lambda: TS.cosine_decay(0.05, 8, alpha=0.1)),
    "linear_warmup_cosine": (lambda: JS.linear_warmup_cosine(0.05, 3, 9), lambda: TS.linear_warmup_cosine(0.05, 3, 9)),
}


def _tree(rng, scale=1.0):
    return {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}


def _close(got, want, what):
    g, w = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w), what
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("sched", sorted(SCHEDULES))
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_ten_steps_match_the_reference(name, sched):
    jmake, tmake, kw = OPTIMIZERS[name]
    jlr, tlr = SCHEDULES[sched]
    jopt, topt = jmake(jlr(), **kw), tmake(tlr(), **kw)
    rng = np.random.default_rng(7)
    p0 = _tree(rng)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p0), tree_from_numpy(p0)
    js, ts = jopt.init(jp), topt.init(tp)
    _close(ts, js, "init state")
    for step in range(10):
        g = _tree(rng, scale=0.1 * (step + 1))
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tu, ts = topt.update(tree_from_numpy(g), ts, tp)
        jp, tp = J.apply_updates(jp, ju), T.apply_updates(tp, tu)
        _close(tu, ju, f"updates, step {step}")
        _close(ts, js, f"state, step {step}")
        _close(tp, jp, f"params, step {step}")
    assert int(ts.step) == 10


def test_adafactor_factors_only_large_leaves():
    st = port_adafactor_mod.adafactor(0.01).init(tree_from_numpy(_tree(np.random.default_rng(0))))
    assert isinstance(st.slots["big"], port_adafactor_mod._FactoredSlot)
    assert tuple(st.slots["big"].vr.shape) == (256,) and tuple(st.slots["big"].vc.shape) == (130,)
    assert tuple(st.slots["small"].shape) == (3, 4) and tuple(st.slots["bias"].shape) == (7,)


@pytest.mark.parametrize("max_norm", [0.5, 1e3], ids=["clipped", "unclipped"])
def test_clip_by_global_norm(max_norm):
    g = _tree(np.random.default_rng(3))
    want = J.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, g), max_norm)
    got = T.clip_by_global_norm(tree_from_numpy(g), max_norm)
    _close(got, want, "clipped grads")
    norm = float(torch.sqrt(sum(torch.sum(x ** 2) for x in tree_leaves(got))))
    assert (norm < max_norm * (1 + 1e-5)) if max_norm < 1 else torch.equal(got["big"], tree_from_numpy(g)["big"])


@pytest.mark.parametrize("sched", sorted(SCHEDULES))
def test_schedules_match_the_reference(sched):
    jlr, tlr = SCHEDULES[sched]
    jf, tf = J._as_schedule(jlr()), T._as_schedule(tlr())
    for step in range(40):
        want = np.asarray(jf(jnp.asarray(step, jnp.int32)))
        got = tf(torch.tensor(step, dtype=torch.int32)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=f"step {step}")
